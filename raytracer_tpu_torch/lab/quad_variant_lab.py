"""K1/K2 variant lab: csrc/quad_traverse.cu rebuilt with other values of
its two tuning constants, timed against each other on the render path's
ray sets. The constants are kGroup (G, the triangles of a leaf row whose
loads start together) and kRefillAt (the idle lanes of a warp's 32 at
which it fetches new rays; 32 waits for the whole warp).

    python -m raytracer_tpu_torch.lab.quad_variant_lab [--reps 20]
        [--against DIR]

Bakes the 300k atrium at leaf 16 (the render path's bake) and builds the
closest-hit sets of lab.rays (primary rays, the bounce-1 wavefront in the
renderer's order) and its NEE shadow batches (bounces 0 and 1). The
variants: each G of GROUPS at the source's refill threshold, and each
threshold of REFILLS at the source's G. Each is built with nvcc from an
edited copy of the source (all at once, into the build directory; csrc/ is
not touched) and must equal the plain versions on every ray of every set
(bit equality), else the lab exits non-zero. Then it prints, per variant,
its registers and ptxas spills, resident blocks a SM, the ms of each set
(CUDA events, mean of --reps, in two passes over the variants, the second
in reverse order) and the sum of the sets' means, and a digest of each
kernel's SASS (its instruction count and a hash of the instructions'
text, from cuobjdump).

--against DIR also builds DIR/quad_traverse.cu, another tree's K1/K2 (its
csrc/ directory, e.g. a parent commit unpacked with `git archive`), with
the same flags and the headers beside it, and gates, times and digests it
as one more variant: equal digests mean the two trees compile K1/K2 to
the same machine code. It also builds both trees' binary_traverse.cu,
lab_traverse.cu, lab2_traverse.cu and lab3_traverse.cu and prints, for
each, how many of its kernels' SASS digests (K3 and K4, L1-L11) equal the
other tree's, and both digests of each that differs (those kernels are not
timed here; chip_smoke.py phases 2 and 6-9 gate and time them).
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import glob
import hashlib
import os
import re
import subprocess
import sys

import torch

from raytracer_tpu_torch.lab import fixed_seq as fs
from raytracer_tpu_torch.lab import queue_walk as qw
from raytracer_tpu_torch.lab import rays as lab_rays
from raytracer_tpu_torch.ops import _build
from raytracer_tpu_torch.ops import quad_traverse as qt

LEAF_SIZE = 16
SOURCE = os.path.join(_build.CSRC_DIR, "quad_traverse.cu")
CONSTANTS = {"group": "kGroup", "refill_at": "kRefillAt"}
GROUPS = (2, 4, 8)
REFILLS = (1, 4, 8, 16, 24, 32)
REPS = 20
CLOSEST_SETS = ("primary", "bounce1")
SHADOW_SETS = ("shadow_b0", "shadow_b1")


def _pattern(name):
    return re.compile(rf"constexpr int {name} = (\d+);")


def source_values(text):
    """{"group", "refill_at"} -> the value the source sets."""
    out = {}
    for key, name in CONSTANTS.items():
        found = _pattern(name).findall(text)
        if len(found) != 1:
            raise ValueError(f"{name} is set {len(found)} times, not once")
        out[key] = int(found[0])
    return out


def variant_source(text, group, refill_at):
    """The source with kGroup = group and kRefillAt = refill_at."""
    source_values(text)  # each set exactly once
    for name, value in (("kGroup", group), ("kRefillAt", refill_at)):
        text = _pattern(name).sub(f"constexpr int {name} = {value};", text)
    return text


def variants(values):
    """(group, refill_at) of every variant: each of GROUPS at the source's
    refill threshold, then each other one of REFILLS at the source's G."""
    out = [(g, values["refill_at"]) for g in GROUPS]
    out += [(values["group"], r) for r in REFILLS if r != values["refill_at"]]
    return out


def _build_lib(src, stem, csrc_dir, headers):
    """(library, ptxas log, path) of quad_traverse source `src`, compiled
    with the repo's flags and `csrc_dir` on the include path."""
    path = _build.compile_library(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc_dir], src, stem,
        headers=headers)
    lib = _build.bind(ctypes.CDLL(path), _build.QUAD_TRAVERSE_SIGNATURES)
    return lib, _build.build_info[stem]["log"], path


def build_variant(text, group, refill_at):
    """(the variant's library, its ptxas log, its path)."""
    stem = f"libquad_traverse_g{group}_r{refill_at}"
    os.makedirs(_build.build_dir(), exist_ok=True)
    src = os.path.join(_build.build_dir(), f"{stem}.cu")
    with open(src, "w") as f:
        f.write(variant_source(text, group, refill_at))
    return _build_lib(src, stem, _build.CSRC_DIR, _build.CUDA_HEADERS)


def build_against(csrc_dir):
    """(library, ptxas log, path, {"group", "refill_at"}) of another tree's
    csrc_dir/quad_traverse.cu, its headers the .cuh files beside it."""
    src = os.path.join(csrc_dir, "quad_traverse.cu")
    with open(src) as f:
        values = source_values(f.read())
    headers = sorted(glob.glob(os.path.join(csrc_dir, "*.cuh")))
    return (*_build_lib(src, "libquad_traverse_against", csrc_dir, headers),
            values)


def sass_digest(sass, kernel):
    """(instructions, a 12-digit hash of their text) of the function whose
    name contains `kernel` in `sass` (cuobjdump -sass output), without its
    name, addresses and encodings, so two builds of the same code agree."""
    ins, inside = [], False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?)\s*;", line)
        if inside and m:
            ins.append(m.group(1))
    return len(ins), hashlib.sha1("\n".join(ins).encode()).hexdigest()[:12]


# The kernels whose SASS --against compares, by source (the distinctive
# part of each mangled name): K3 and K4, every persistent lab kernel (L1-L9,
# queue_walk.LAUNCH_KERNELS) and the fixed-sequence ones (L10, L11,
# fixed_seq.LAUNCH_KERNELS).
DIGESTS = {
    "binary_traverse": ("closest_kernel", "occlusion_kernel"),
    **{lib: tuple(name for where, name, _ in qw.LAUNCH_KERNELS.values()
                  if where == lib)
       for lib in ("lab_traverse", "lab2_traverse")},
    "lab3_traverse": tuple(name for _, name in fs.LAUNCH_KERNELS),
}


def library_digests(csrc_dir, tag, name):
    """{kernel: sass_digest} of DIGESTS[name]: csrc_dir/<name>.cu built as
    lib<name>_<tag> with the repo's flags and the headers beside it."""
    headers = sorted(glob.glob(os.path.join(csrc_dir, "*.cuh")))
    path = _build.compile_library(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", csrc_dir],
        os.path.join(csrc_dir, f"{name}.cu"), f"lib{name}_{tag}",
        headers=headers)
    sass = library_sass(path)
    return {k: sass_digest(sass, k) for k in DIGESTS[name]}


def library_sass(path):
    """cuobjdump -sass of a library (cuobjdump beside nvcc)."""
    tool = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    return subprocess.run([tool, "-sass", path], capture_output=True,
                          text=True, check=True).stdout


def run(reps=REPS, say=print, against=None):
    """Build, gate and time every variant (and, with `against`, another
    tree's csrc/ build, keyed "against"); returns {(group, refill_at) or
    "against": {"info": launch_info of K1 and K2 with their "spills" and
    "sass" digest, "ms": {set: [pass 1, pass 2]}}}."""
    device = lab_rays.require_cuda()
    with open(SOURCE) as f:
        text = f.read()
    values = source_values(text)
    todo = variants(values)
    names = {v: f"G={v[0]} refill_at={v[1]}" for v in todo}
    with concurrent.futures.ThreadPoolExecutor(len(todo) + 5) as pool:
        jobs = {v: pool.submit(build_variant, text, *v) for v in todo}
        if against:
            jobs["against"] = pool.submit(build_against, against)
            digests = {(name, tag): pool.submit(library_digests, d, tag,
                                                name)
                       for name in DIGESTS for tag, d in (
                           ("this", _build.CSRC_DIR), ("against", against))}
        built = {v: job.result() for v, job in jobs.items()}
    if against:
        for name in DIGESTS:
            this, other = (digests[(name, tag)].result()
                           for tag in ("this", "against"))
            differ = [k for k in this if this[k] != other[k]]
            say(f"{name} SASS (instructions, digest) of {len(this)} kernels: "
                f"{len(this) - len(differ)} equal to {against}'s"
                + "".join(f"; {k} DIFFERENT: this tree {this[k]}, {against} "
                          f"{other[k]}" for k in differ))
        other = built["against"][3]
        names["against"] = (f"{against} (G={other['group']} refill_at="
                            f"{other['refill_at']})")
        todo.append("against")

    ds = lab_rays.atrium(LEAF_SIZE, device)
    closest = lab_rays.closest_sets(ds)
    shadow = lab_rays.shadow_sets(ds)
    scene = (ds.root, ds.qmeta, ds.qnodes, ds.ptris)
    calls, refs = {}, {}
    for name in CLOSEST_SETS:
        o, d, tm = closest[name]
        calls[name] = lambda lib, o=o, d=d, tm=tm: qt._intersect_quad_cuda(
            o, d, tm, ds, lib)
        refs[name] = qt._intersect_quad_plain(o, d, tm, *scene)
    for name in SHADOW_SETS:
        o, d, tm, skip, _ = shadow[name]
        calls[name] = lambda lib, o=o, d=d, tm=tm, skip=skip: (
            qt._occlusion_quad_cuda(o, d, tm, skip, ds, lib),)
        refs[name] = (qt._occlusion_quad_plain(o, d, tm, skip, *scene),)

    out = {}
    for v in todo:
        lib, log, path = built[v][:3]
        for name, call in calls.items():
            got = call(lib)
            if not all(torch.equal(a, b) for a, b in zip(got, refs[name])):
                raise RuntimeError(f"variant {names[v]} != the plain "
                                   f"version on {name}")
        info = {k: qt.launch_info(k, ds, lib) for k in ("closest",
                                                         "occlusion")}
        sass = library_sass(path)
        for k in info:
            info[k]["spills"] = _build.ptxas_spills(log, f"{k}_kernel")
            info[k]["sass"] = sass_digest(sass, f"{k}_kernel")
        out[v] = {"info": info, "ms": {name: [] for name in calls}}
    for v in todo + todo[::-1]:
        lib = built[v][0]
        for name, call in calls.items():
            out[v]["ms"][name].append(
                lab_rays.cuda_ms(lambda: call(lib), reps))

    n = {name: int((closest[name][2] > qt.T_MIN).sum())
         for name in CLOSEST_SETS}
    n.update({name: int(shadow[name][4].sum()) for name in SHADOW_SETS})
    say(f"quad_variant_lab: atrium leaf {LEAF_SIZE}, stack need "
        f"{ds.q_stack_need}; live rays of {lab_rays.WIDTH * lab_rays.HEIGHT}: "
        + ", ".join(f"{k} {c}" for k, c in n.items())
        + f"; the source's G = {values['group']}, refill at "
        f"{values['refill_at']}; every variant equal to the plain versions "
        "on every ray")
    for v in todo:
        parts = []
        for k, i in out[v]["info"].items():
            st, ld = i["spills"]
            parts.append(f"{k} {i['registers']} registers, spills {st}/{ld} "
                         f"B, {i['blocks_per_sm']} blocks a SM, SASS "
                         f"{i['sass'][0]} instructions #{i['sass'][1]}")
        ms = out[v]["ms"]
        total = sum(sum(m) / 2 for m in ms.values())
        say(f"{names[v]}: " + "; ".join(parts) + "; ms (two "
            "passes) " + ", ".join(f"{name} {m[0]:.3f}/{m[1]:.3f}"
                                   for name, m in ms.items())
            + f"; sum of the means {total:.3f}")
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=REPS)
    p.add_argument("--against", metavar="DIR",
                   help="another tree's csrc/ directory to build and time")
    args = p.parse_args(argv)
    say = lambda m: print(m, flush=True)  # noqa: E731
    run(args.reps, say, args.against)
    say(f"quad_variant_lab on {lab_rays.card_line()} (SM clock read after "
        "the runs)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
