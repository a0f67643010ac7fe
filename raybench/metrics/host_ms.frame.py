"""Host time a frame in the port's own span: `rt.render`'s mean duration
over the first traced window's frames (its launches, its Python and its
waits at host-device syncs), in ms."""

from raybench.harness.spans import mean_ms


def read(run):
    return mean_ms(run, "rt.render", outer=True) if run["mode"] == "frames" else None
