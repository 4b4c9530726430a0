"""f32_apply_roofline.voxel: percent of its roofline bound in the mean
device time of K1's masked float32 stencil kernel (``csrc/stencil.cu``,
``stencil27_kernel<float, true, ...>``), the apply on the V-cycle's
finest level on the voxel route (its Chebyshev smoothing and residual),
over the traced slice. Bound: the state in and out, the free mask and
the region table once, at 3.35 TB/s, or the operations at 67 TFLOP/s,
whichever is larger."""
from benchmark.harness import roofline

UNIT = "%"
LAYER = "kernels"
MOVES = "solved_dof_per_s"
KERNEL = "stencil27_kernel<float, true"


def read(run):
    if run.trace is None:
        return None
    bound, _ = roofline.voxel_apply(run.config["cells"], "float32", masked=True)
    return roofline.share(run.trace, KERNEL, bound)
