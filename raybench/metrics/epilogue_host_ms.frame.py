"""Host time a frame of the bounce loop's shading epilogue: the self time
of the `rt.render.shade` spans (each depth's epilogue, its shadow traces
left out) over the first traced window's frames, in ms."""

from raybench.harness.spans import self_ms


def read(run):
    return self_ms(run, "rt.render.shade") if run["mode"] == "frames" else None
