"""f64_apply_roofline.voxel: percent of its roofline bound in the mean
device time of K2's masked float64 stencil kernel (``csrc/stencil.cu``,
``stencil27_kernel<double, true, ...>``), the finest level's f64 apply
of the FCG on the voxel route, over the traced slice. Bound: the state
in and out, the free mask and the region table once, at 3.35 TB/s, or
the operations at 34 TFLOP/s, whichever is larger."""
from benchmark.harness import roofline

UNIT = "%"
LAYER = "kernels"
MOVES = "solved_dof_per_s"
KERNEL = "stencil27_kernel<double, true"


def read(run):
    if run.trace is None:
        return None
    bound, _ = roofline.voxel_apply(run.config["cells"], "float64", masked=True)
    return roofline.share(run.trace, KERNEL, bound)
