"""The traversal lab: the port's counterpart of the JAX package's traversal
lab tools (tools/kernel_lab.py, occl_lab.py, bvh4_lab.py, v2_kernel_lab.py,
v3_kernel_lab.py, v4_interleave_lab.py, r3_kernel_lab.py).

Each module runs one lab's kernels, hand-written CUDA in
csrc/lab_traverse.cu (L1, L9, L2) or csrc/lab2_traverse.cu (L3-L6), on the
lab's own workload (the procedural 300k-triangle atrium at 1920x1080 from
the bench camera) and prints what the JAX lab prints, with the card's
numbers:

    python -m raytracer_tpu_torch.lab.kernel_lab          # L1
    python -m raytracer_tpu_torch.lab.occl_lab            # L9
    python -m raytracer_tpu_torch.lab.bvh4_lab            # L2
    python -m raytracer_tpu_torch.lab.v2_kernel_lab       # L3
    python -m raytracer_tpu_torch.lab.v3_kernel_lab       # L4
    python -m raytracer_tpu_torch.lab.v4_interleave_lab   # L5
    python -m raytracer_tpu_torch.lab.r3_kernel_lab       # L6

L1 is the binary closest hit with visit counters, L9 the any hit with
counters, L2 the 4-wide closest hit, L3 component-major leaves, L4 the
deferred-leaf walk with step counters, L5 two such walks per thread, L6
the deferred-leaf walk on the 4-wide tree.

Each needs a CUDA device. The wrappers take CPU tensors too and then run
the kernels' plain torch versions, which the tests compare with the JAX
lab kernels. `rays` builds the lab's ray sets; `queue_walk` is the plain
deferred-leaf walk of L4-L6.
"""
