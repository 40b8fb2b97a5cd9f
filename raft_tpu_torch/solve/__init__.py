"""RAO fixed point and eigen analysis."""
