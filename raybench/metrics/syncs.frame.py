"""Host-device synchronisations a frame that the port makes: its
`rt.sync.*` counters over the first traced window's frames, a count."""

from raybench.harness.spans import count_per_call


def read(run):
    return count_per_call(run, "rt.sync.") if run["mode"] == "frames" else None
