"""ptq_kernels_per_mparam (kernels/Mparam): the device kernels in the traced
window (copies and sets left out) per million parameters of the matrices
quantized in it."""


def read(run):
    ops = getattr(run, "ops", None)
    if not ops or not run.traced_params:
        return None
    kernels = sum(1 for name, _, _ in ops
                  if not name.startswith(("Memcpy", "Memset")))
    return kernels / (run.traced_params / 1e6)
