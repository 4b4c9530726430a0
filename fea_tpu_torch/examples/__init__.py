"""The demos of the reference's ``examples/``, on ``fea_tpu_torch``: each
prints what its JAX twin prints.

    python -m fea_tpu_torch.examples.<name> [--device cpu] [--show]

``<name>`` is one of ``cubebeam``, ``euler_bernoulli``, ``truss``,
``single_element``, ``tube``, ``lshape``, ``sweep``, ``unstructured``.
Each runs on the card unless given ``--device cpu``; ``--show`` renders
with matplotlib (pyvista where installed). Each module's ``main(argv)``
takes the command line's arguments as a list.
"""

NAMES = ("cubebeam", "euler_bernoulli", "truss", "single_element", "tube", "lshape", "sweep", "unstructured")
