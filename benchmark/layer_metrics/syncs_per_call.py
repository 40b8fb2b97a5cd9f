"""Host calls that waited for the card per call of the entry: stream,
device and event synchronisations and blocking copies, from the profile's
runtime events, the harness's own synchronisation left out."""
from benchmark.harness import profile


def read(ctx, tag):
    return profile.host_syncs(ctx["profile"]) / ctx["n_calls"]
