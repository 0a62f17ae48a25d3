"""The traversal lab: the port's counterpart of the JAX package's lab tools
that reach a Pallas kernel (tools/kernel_lab.py, occl_lab.py, bvh4_lab.py,
v2_kernel_lab.py, v3_kernel_lab.py, v4_interleave_lab.py, r3_kernel_lab.py,
r3_oct_lab.py, r3_occl3_lab.py, visit_cost_lab.py, smem_lab.py,
bf16_lab.py).

Each module runs one lab's kernels, hand-written CUDA in
csrc/lab_traverse.cu (L1, L9, L2), csrc/lab2_traverse.cu (L3-L8),
csrc/lab3_traverse.cu (L10, L11) or csrc/bf16_lab.cu (L12), on the lab's
own workload (the procedural 300k-triangle atrium at 1920x1080 from the
bench camera; for L10-L12 a fixed sequence, see `fixed_seq`) and prints
what the JAX lab prints, with the card's numbers:

    python -m raytracer_tpu_torch.lab.kernel_lab             # L1
    python -m raytracer_tpu_torch.lab.occl_lab               # L9
    python -m raytracer_tpu_torch.lab.bvh4_lab               # L2
    python -m raytracer_tpu_torch.lab.v2_kernel_lab          # L3
    python -m raytracer_tpu_torch.lab.v3_kernel_lab          # L4
    python -m raytracer_tpu_torch.lab.v4_interleave_lab      # L5
    python -m raytracer_tpu_torch.lab.r3_kernel_lab          # L6
    python -m raytracer_tpu_torch.lab.r3_oct_lab             # L7
    python -m raytracer_tpu_torch.lab.r3_occl3_lab           # L8
    python -m raytracer_tpu_torch.lab.visit_cost_lab [--leaf]  # L11a [L11b]
    python -m raytracer_tpu_torch.lab.smem_lab               # L10
    python -m raytracer_tpu_torch.lab.bf16_lab               # L12

L1 is the binary closest hit with visit counters, L9 the any hit with
counters, L2 the 4-wide closest hit, L3 component-major leaves, L4 the
deferred-leaf walk with step counters, L5 two such walks per thread, L6
the deferred-leaf walk on the 4-wide tree, L7 on the 8-wide tree, L8 the
deferred-leaf any hit with the near child first. L11 ablates the cost of
one node visit (a) and one leaf visit (b), L10 stages a leaf row in shared
memory or reads it column-wise, L12 times f32 against packed bf16x2
multiply-add chains.

Each needs a CUDA device. The wrappers take CPU tensors too and then run
the kernels' plain torch versions, which the tests compare with the JAX
lab kernels. `rays` builds the lab's ray sets; `queue_walk` is the plain
deferred-leaf walk of L4-L8; `fixed_seq` is the fixed-sequence harness of
L10-L12.

One more lab has no JAX counterpart: `quad_variant_lab` rebuilds the
render path's K1/K2 (csrc/quad_traverse.cu) with other values of their
two tuning constants and times them on the lab's sets:

    python -m raytracer_tpu_torch.lab.quad_variant_lab
"""
