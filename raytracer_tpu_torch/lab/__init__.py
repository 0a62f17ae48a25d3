"""The traversal lab: the port's counterpart of the JAX package's traversal
lab tools (tools/kernel_lab.py, tools/occl_lab.py, tools/bvh4_lab.py).

Each module runs one lab's kernels, hand-written CUDA in
csrc/lab_traverse.cu, on the lab's own workload (the procedural
300k-triangle atrium at 1920x1080 from the bench camera) and prints what the
JAX lab prints, with the card's numbers:

    python -m raytracer_tpu_torch.lab.kernel_lab   # L1: closest hit + counts
    python -m raytracer_tpu_torch.lab.occl_lab     # L9: any hit + counts
    python -m raytracer_tpu_torch.lab.bvh4_lab     # L2: 4-wide closest hit

Each needs a CUDA device. The wrappers take CPU tensors too and then run
the kernels' plain torch versions, which the tests compare with the JAX
lab kernels. `rays` builds the lab's ray sets.
"""
