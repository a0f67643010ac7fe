"""Host time a train step in the port's own span: `rt.fit.step`'s mean
duration over the first traced window's steps (its launches, its Python
and its waits at host-device syncs), in ms."""

from raybench.harness.spans import mean_ms


def read(run):
    return mean_ms(run, "rt.fit.step", outer=True) if run["mode"] == "fit" else None
