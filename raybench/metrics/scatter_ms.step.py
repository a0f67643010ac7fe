"""Device time a train step of the backward's scatter-adds (the
`index_add_` kernels of `core/vecmath.take`'s backward), in ms."""

from raybench.harness.readers import KERNELS, device_s_per_call


def read(run):
    if run["mode"] != "fit":
        return None
    s = device_s_per_call(run, KERNELS["scatter"])
    return None if s is None else 1e3 * s
