"""f32_apply_roofline.curv: percent of its roofline bound in the mean
device time of K4's masked float32 kernel (``csrc/varstencil.cu``,
``var27_sym_kernel<float, false, true>``), the finest level's apply in
the curvilinear route's V-cycle (its Chebyshev smoothing and residual),
over the traced slice. Bound: the state in and out and the free mask
once, and the 14 symmetric 3 x 3 blocks a symmetric field needs, at 3.35
TB/s, or the operations at 67 TFLOP/s, whichever is larger."""
from benchmark.harness import roofline

UNIT = "%"
LAYER = "kernels"
MOVES = "solved_dof_per_s"
KERNEL = "var27_sym_kernel<float, false, true>"


def read(run):
    if run.trace is None:
        return None
    bound, _ = roofline.var_apply(run.config["cells"], "float32", masked=True)
    return roofline.share(run.trace, KERNEL, bound)
