"""Host time a train step of the autograd backward: `rt.fit.backward`
(around `loss.backward()`) over the first traced window's steps, in
ms."""

from raybench.harness.spans import mean_ms


def read(run):
    return mean_ms(run, "rt.fit.backward") if run["mode"] == "fit" else None
