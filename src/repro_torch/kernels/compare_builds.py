"""Time CUDA libraries built from several source trees, in one process on
one card: those built on the 3xTF32 tile (tc_gemm_tile.cuh's `mma_tile`),
block_matmul over the Cora-width GCN's four serving products (a 4 x 3072
batch: X @ W1, A @ H1, X2 @ W2, A @ H2), fused_gat_full over the Cora
GAT's two serving layers (4 x 3072: 1433 features to 8 heads of 8, ELU;
64 to 1 head of 7), fused_sage over the Cora SAGE's four (4 x 3072,
mean and max: 1433 features to 64, ReLU; 64 to 7; 10 sampled neighbours
and the self loop a row), and the GCN layers at their padded serving
widths (4 x 3072: 1536 features to 128, ReLU; 128 to 128):
fused_gcn_dense over a dense Â, fused_gcn_grasp over a GraSp structure of
one diagonal block a block row (graphs of 1800, 2700, 1800 and 2700
nodes, budget 6: clustered graphs with no cross edges); and the SAGE row
walk's sage_max over the Cora SAGE-max's two square serving
aggregations (4 x 3072 sampled masks over pooled features 1433 and 64
wide). A tree whose sage_max.cu predates the rectangular mask (its C
entry takes one node count) is bound with that signature.

Run from the checkout's root. Each argument is LABEL=DIR or
LABEL=DIR,OPTION,...: DIR is a `csrc` directory holding the libraries'
sources and the headers they include (this checkout's
`src/repro_torch/kernels/csrc`, or an earlier commit's, unpacked with
`git archive` into a git-ignored directory such as build/). An OPTION is
an extra nvcc flag (`-DTC_SPLIT_INT=0`), or `int-split`: build a copy of
a tree whose split_tf32 still rounds with cvt.rna.tf32.f32 with the
integer rounding instead (the same bits), so that two tile layouts are
compared at one rounding. `--libraries=NAME,...` compares only the named
libraries (all of LIBRARIES by default).

For each library, prints each build's ptxas registers and SASS instruction
count, checks that every build's outputs equal the first build's bit for
bit, then the batch's time queued behind a spin (`timing.queued_ms`) for
each build in the order given and back, three times: median, min and
max.

    PYTHONPATH=src python3 -m repro_torch.kernels.compare_builds \\
        --libraries=block_matmul,fused_gcn_dense \\
        now=src/repro_torch/kernels/csrc \\
        now-cvt=src/repro_torch/kernels/csrc,-DTC_SPLIT_INT=0 \\
        old=build/parent/src/repro_torch/kernels/csrc \\
        old-int=build/parent/src/repro_torch/kernels/csrc,int-split
"""
from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.timing import card_line, queued_ms

OUT = _build.BUILD_DIR / "compare"
CVT_SPLIT = ('  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(big) : "f"(x));\n'
             '  const float rest = x - __uint_as_float(big);\n'
             '  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(small) : '
             '"f"(rest));\n')
INT_SPLIT = ('  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n'
             '  const float rest = x - __uint_as_float(big);\n'
             '  small = (__float_as_uint(rest) + 0x1000u) & 0xffffe000u;\n')


def source_tree(label: str, src: Path, int_split: bool,
                out: Path = OUT) -> Path:
    """The tree to build LABEL from: `src`, or with int_split a copy under
    `out` with the integer split."""
    if not int_split:
        return src
    tree = out / f"{label}_src"
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(src, tree)
    tile = tree / "tc_gemm_tile.cuh"
    text = tile.read_text()
    if CVT_SPLIT not in text:
        raise SystemExit(f"{label}: {src} has no cvt.rna split to replace")
    tile.write_text(text.replace(CVT_SPLIT, INT_SPLIT))
    return tree


LIBRARIES = ("block_matmul", "fused_gat_full", "fused_sage",
             "fused_gcn_dense", "fused_gcn_grasp", "sage_max")


def build_all(specs, names=LIBRARIES):
    """Compile every build of every named library at once: {(label,
    library): (shared library, ptxas log)}."""
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for label, (tree, flags) in specs.items():
        for name in names:
            lib = OUT / f"{label}_{name}.so"
            procs[label, name] = (lib, subprocess.Popen(
                [_build.nvcc_path(), *_build.NVCC_FLAGS, *flags, "-o",
                 str(lib), str(tree / f"{name}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    built = {}
    for key, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise SystemExit(f"{key}: nvcc failed\n{log}")
        built[key] = (lib, log)
    return built


def workloads(dev):
    """Per library, (outputs, run(fn)): the serving batch each build's
    entry point computes into `outputs`."""
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, scale=1.0):
        return torch.randn(*shape, device=dev, generator=gen) * scale

    stream = torch.cuda.current_stream(dev).cuda_stream
    ordinal = dev.index or 0

    def check(err):
        if err != 0:
            raise SystemExit(f"launch failed: cudaError {err}")

    adj = rand(4, 3072, 3072).abs() / 3072
    products = [(rand(4, 3072, 1536), rand(1536, 128)),
                (adj, rand(4, 3072, 128)),
                (rand(4, 3072, 128), rand(128, 128)),
                (adj, rand(4, 3072, 128))]
    mm_outs = [torch.empty(4, 3072, 128, device=dev) for _ in products]

    def matmuls(fn):
        for (a, b), out in zip(products, mm_outs):
            m, k = a.shape[-2:]
            n = b.shape[-1]
            check(fn(a.data_ptr(), b.data_ptr(), out.data_ptr(), 4, m, n, k,
                     m * k if a.dim() == 3 else 0,
                     k * n if b.dim() == 3 else 0, ordinal, stream))

    # the GAT layers' additive mask: 0 on about 0.3% of the columns and on
    # the diagonal, -1e9 elsewhere
    keep = torch.rand(4, 3072, 3072, device=dev, generator=gen) < 3e-3
    keep |= torch.eye(3072, dtype=torch.bool, device=dev)
    bias = torch.where(keep, 0.0, -1e9)
    layers = []
    for fin, heads, f, act in ((1433, 8, 8, 2), (64, 1, 7, 0)):
        x = rand(4, 3072, fin)
        w = rand(fin, heads, f, scale=fin ** -0.5)
        args = (x, w, rand(heads, f), rand(heads, f), bias,
                rand(heads, f, scale=0.1))
        scratch = (torch.empty(4, 3072, heads, f, device=dev),
                   torch.empty(4, 3072, heads, device=dev),
                   torch.empty(4, 3072, heads, device=dev))
        layers.append((args, scratch, torch.empty(4, 3072, heads, f,
                                                  device=dev),
                       (4, 3072, fin, heads, f, act)))

    def gat(fn):
        for args, scratch, out, sizes in layers:
            check(fn(*(t.data_ptr() for t in (*args, *scratch, out)),
                     *sizes, ordinal, stream))

    # the SAGE layers' masks: 10 sampled columns and the diagonal a row
    # (0/1 for max), row-normalised for mean; the max layers aggregate
    # pooled (non-negative) features
    sample = torch.zeros(4, 3072, 3072, device=dev)
    sample.scatter_(2, torch.randint(0, 3072, (4, 3072, 10), device=dev,
                                     generator=gen), 1.0)
    sample += torch.eye(3072, device=dev) * (1 - sample.diagonal(
        dim1=1, dim2=2)).unsqueeze(-1)
    mean = sample / sample.sum(-1, keepdim=True)
    sage = []
    for mask, is_max in ((mean, 0), (sample, 1)):
        for fin, o, act in ((1433, 64, 1), (64, 7, 0)):
            x = rand(4, 3072, fin) if fin == 1433 else rand(
                4, 3072, fin).relu()
            xk = rand(4, 3072, fin).abs() if is_max else x
            ldg = -(-fin // 4) * 4
            args = (mask, xk, x, rand(fin, o, scale=fin ** -0.5),
                    rand(fin, o, scale=fin ** -0.5), rand(o, scale=0.1),
                    torch.empty(4, 3072, ldg, device=dev))
            sage.append((args, torch.empty(4, 3072, o, device=dev),
                         (4, 3072, fin, ldg, o, is_max, act)))

    def sage_layers(fn):
        for args, out, sizes in sage:
            check(fn(*(t.data_ptr() for t in (*args, out)), *sizes, ordinal,
                     stream))

    # sage_max: the max layers' square walks, (4, 3072, 3072) @ (4, 3072, F)
    walks = [(sample, rand(4, 3072, f).abs(),
              torch.empty(4, 3072, f, device=dev)) for f in (1433, 64)]

    def sage_walks(fn):
        for mask, h, out in walks:
            check(fn(mask.data_ptr(), h.data_ptr(), out.data_ptr(), 4, 3072,
                     3072, h.shape[-1], ordinal, stream))

    # the GCN layers: the dense Â above, and a GraSp structure of one
    # diagonal block a real block row (counts 0 on NodePad's rows)
    rb, budget = 3072 // 128, 6
    counts = torch.zeros(4, rb, dtype=torch.int32, device=dev)
    for z, n in enumerate((1800, 2700, 1800, 2700)):
        counts[z, :-(-n // 128)] = 1
    cols = torch.zeros(4, rb, budget, dtype=torch.int32, device=dev)
    cols[:, :, 0] = torch.arange(rb, dtype=torch.int32, device=dev)
    blocks = rand(4, rb, budget, 128, 128).abs() / 128
    blocks[:, :, 1:] = 0.0
    blocks = blocks.reshape(4, rb * budget, 128, 128)
    gcn = []
    for fin, act in ((1536, 1), (128, 0)):
        gcn.append((rand(4, 3072, fin), rand(fin, 128, scale=fin ** -0.5),
                    rand(128, scale=0.1), act))
    dense_outs = [torch.empty(4, 3072, 128, device=dev) for _ in gcn]
    grasp_outs = [torch.empty(4, 3072, 128, device=dev) for _ in gcn]
    scratch = torch.empty(4, 3072, 128, device=dev)

    def gcn_dense(fn):
        for (x, w, b, act), out in zip(gcn, dense_outs):
            check(fn(adj.data_ptr(), x.data_ptr(), w.data_ptr(),
                     b.data_ptr(), scratch.data_ptr(), out.data_ptr(), 4,
                     3072, x.shape[-1], 128, act, ordinal, stream))

    def gcn_grasp(fn):
        for (x, w, b, act), out in zip(gcn, grasp_outs):
            check(fn(blocks.data_ptr(), cols.data_ptr(), counts.data_ptr(),
                     x.data_ptr(), w.data_ptr(), b.data_ptr(),
                     scratch.data_ptr(), out.data_ptr(), 4, rb, budget,
                     x.shape[-1], 128, act, ordinal, stream))

    return {"block_matmul": (mm_outs, matmuls),
            "fused_gat_full": ([out for *_, out, _ in layers], gat),
            "fused_sage": ([out for _, out, _ in sage], sage_layers),
            "fused_gcn_dense": (dense_outs, gcn_dense),
            "fused_gcn_grasp": (grasp_outs, gcn_grasp),
            "sage_max": ([out for *_, out in walks], sage_walks)}


def bind(name: str, lib: Path, tree: Path):
    """The built library's C entry point, with the current signature; an
    earlier tree's square-only sage_max (batch, n, f) is adapted to it
    (rows == n)."""
    symbol, kinds = _build.ENTRY_POINTS[name]
    square_only = (name == "sage_max"
                   and "int rows" not in (tree / "sage_max.cu").read_text())
    if square_only:
        kinds = "ppp" "iii" "ip"
    fn = getattr(ctypes.CDLL(str(lib)), symbol)
    fn.argtypes = [_build._CTYPES[k] for k in kinds]
    fn.restype = ctypes.c_int
    if not square_only:
        return fn

    def square(mask, h, out, batch, rows, n, f, device, stream):
        if rows != n:
            raise SystemExit(f"{lib}: sage_max takes square masks only")
        return fn(mask, h, out, batch, n, f, device, stream)
    return square


def main(argv) -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    specs, names = {}, LIBRARIES
    for arg in argv:
        if arg.startswith("--libraries="):
            names = tuple(arg.partition("=")[2].split(","))
            unknown = sorted(set(names) - set(LIBRARIES))
            if unknown:
                raise SystemExit(f"unknown libraries {unknown}; "
                                 f"LIBRARIES: {LIBRARIES}")
            continue
        label, _, rest = arg.partition("=")
        src, *options = rest.split(",")
        flags = [o for o in options if o != "int-split"]
        specs[label] = (source_tree(label, Path(src), "int-split" in options),
                        flags)
    if not specs:
        raise SystemExit(__doc__)
    card = card_line()
    fns = {name: {} for name in names}
    for (label, name), (lib, log) in build_all(specs, names).items():
        regs = re.findall(r"Used (\d+) registers", log)
        sass = subprocess.run([_build.cuobjdump_path(), "-sass", str(lib)],
                              capture_output=True, text=True,
                              check=True).stdout
        count = len(re.findall(r"/\*[0-9a-f]{4}\*/", sass))
        print(f"{label} {name}: registers per kernel {regs}, {count} SASS "
              f"instructions", flush=True)
        fns[name][label] = bind(name, lib, specs[label][0])

    work = workloads(torch.device("cuda"))
    for name in names:
        outs, run = work[name]
        first = None
        for label, fn in fns[name].items():
            run(fn)
            torch.cuda.synchronize()
            got = [o.clone() for o in outs]
            first = first or (label, got)
            if not all(torch.equal(x, y) for x, y in zip(first[1], got)):
                raise SystemExit(f"{label}'s {name} outputs differ from "
                                 f"{first[0]}'s")
        print(f"{name}: every build's outputs equal {first[0]}'s bit for "
              "bit", flush=True)

        times = {label: [] for label in fns[name]}
        order = list(fns[name])
        for _ in range(3):
            for label in order + order[::-1]:
                times[label].append(queued_ms(
                    lambda: run(fns[name][label])))
        for label, ts in times.items():
            ts = sorted(t for t in ts if t is not None)
            print(f"{label} {name}: per batch, queued behind a spin, median "
                  f"{ts[len(ts) // 2]:.4f} ms (min {ts[0]:.4f}, max "
                  f"{ts[-1]:.4f}, {len(ts)} runs); {card}", flush=True)


if __name__ == "__main__":
    main(sys.argv[1:])
