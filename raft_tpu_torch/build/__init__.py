"""Design dict -> MemberSet / RNA (host build)."""
