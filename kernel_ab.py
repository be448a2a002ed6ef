"""A/B of the port's SPD and tree kernels against older sources, on one
CUDA card, in one process.

    mkdir -p runs/ab/old
    git show <rev>:bayes_sim_ig_tpu_torch/csrc/spd_lanes.cu > runs/ab/old/spd_lanes.cu
    git show <rev>:bayes_sim_ig_tpu_torch/csrc/tree_ltdl.cu > runs/ab/old/tree_ltdl.cu
    python3 kernel_ab.py runs/ab/old

    python3 kernel_ab.py --tree-same runs/ab/old

    python3 kernel_ab.py --half-same runs/ab/old

The second form takes an older ``tree_ltdl.cu`` with the current C
interface of the factor and the substitute (the host-built table of
``ops/tree_solve.py::kernel_table``): it holds both kernels to the old
ones bit for bit (factor H and D; the substitute at K = 1 and K = 4) at
Humanoid's tree (4096 envs) and BallBalance's forest (128 envs), times
them in turns (old, new, new, old) and writes
chiprun_out/kernel_ab_tree_same.json.

The third form takes a ``tree_ltdl.cu`` whose half-solve entries have the
current C interface (``tree_ltdl_upsolve_f32``, ``tree_ltdl_downsolve_f32``:
``722aa60``'s, where they were the substitute kernel's passes). It holds
csrc/tree_half.cu's half-solves to the old ones bit for bit at
``HALF_SAME`` and the current substitute to the old one at K = 1 and 4
(``SUB_SAME``); then, at ShadowHand's shapes, times the old kernels, the
new entries (Kb 8) and, where K > 1, the Kb sweep of csrc/tree_half.cu
in turns (old, new, each variant, then in reverse): Kb 4 and 16
right-hand sides a block (``HALF_VARIANTS``, built with -D flags beside
the package's build).
Writes chiprun_out/kernel_ab_half_same.json.

The old sources must expose the one-thread-per-env C interface (the SPD
entries as today; the tree entries take the table [parent (nv), off
(nv + 1)]). They are built with ``ops/build.py``'s flags into the same
directory and loaded with ctypes beside the current kernels. At each
path shape (SPD at ``SPD_AB``: (14, 1024), Ant's mass matrix, and
(18, 4000), Anymal's on the full-warp instance; the tree kernels at
Humanoid's tree and 4096 envs, and at Ant's tree and 1024 envs) the old
and new kernels are timed in turns (old, new, new, old), each time the
median of 50 calls with CUDA events and the device time per call from
torch.profiler over 50 calls, then the plain version and the library
yardstick once; then the current kernels' floors (``floors``). Prints
one line per entry point and writes everything to
chiprun_out/kernel_ab.json.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as cs
from bayes_sim_ig_tpu_torch.ops import bounds, build, launch
from bayes_sim_ig_tpu_torch.ops import spd_kernel as sk
from bayes_sim_ig_tpu_torch.ops import tree_solve as ts

OUT = os.path.join(cs.HERE, "chiprun_out", "kernel_ab.json")
OUT_SAME = os.path.join(cs.HERE, "chiprun_out", "kernel_ab_tree_same.json")
OUT_HALF = os.path.join(cs.HERE, "chiprun_out", "kernel_ab_half_same.json")
# (tree, N) of the same-interface tree A/B: the paths' trees.
TREE_SAME = [("humanoid", 4096), ("ball_balance", 128)]
SPD_AB = [(14, 1024), (18, 4000)]
# (tree, N, K) of the half-solve A/B: chip_smoke.py's shapes but the edge
# (the old kernels' shared memory does not hold a 256-dof tree of 1,024
# pairs), and K = 1 at 2048, 4096 and 8192 envs, around the route's
# switch at 4,224 (132 warps); all but two are timed.
HALF_SAME = [("shadow_hand", 1024, 51), ("shadow_hand", 1024, 1),
             ("shadow_hand", 10000, 51), ("shadow_hand", 10000, 1),
             ("shadow_hand", 2048, 1), ("shadow_hand", 4096, 1),
             ("shadow_hand", 8192, 1), ("random30", 1027, 4),
             ("shadow_hand", 17, 51)]
HALF_TIMED = HALF_SAME[:7]
SUB_SAME = [("shadow_hand", 1024), ("humanoid", 4096)]
# csrc/tree_half.cu's Kb sweep beside the build's default of 8: -D flags
# of its build.
HALF_VARIANTS = {f"kb{kb}": [f"-DTREE_HALF_KB={kb}"] for kb in (4, 16)}


def _build_old(old_dir, name, src=None, tag="old", flags=()):
    src = src or os.path.join(old_dir, f"{name}.cu")
    lib = os.path.join(old_dir, f"{name}_{tag}.so")
    subprocess.run([build.find_nvcc(), *build.NVCC_FLAGS, *flags, "-o", lib,
                    src], check=True, capture_output=True, text=True)
    return ctypes.CDLL(lib)


def _old_fns(old_dir):
    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        spd = pool.submit(_build_old, old_dir, "spd_lanes")
        tree = pool.submit(_build_old, old_dir, "tree_ltdl")
        new = [pool.submit(launch.load, lib)
               for lib in ("spd_lanes", "tree_ltdl")]
        spd, tree = spd.result(), tree.result()
        for f in new:
            f.result()
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    spd.spd_factor_lanes_f32.argtypes = [ptr, ptr, i32, i32, ptr]
    spd.spd_substitute_lanes_f32.argtypes = [ptr, ptr, ptr, i32, i32, i32,
                                             ptr]
    spd.spd_solve_lanes_f32.argtypes = [ptr, ptr, ptr, i32, i32, ptr]
    tree.tree_ltdl_factor_f32.argtypes = [ptr, i32, i32, ptr, ptr, ptr, i32,
                                          ptr]
    tree.tree_ltdl_substitute_f32.argtypes = [ptr, i32, i32, ptr, ptr, ptr,
                                              ptr, i32, i32, ptr]
    return spd, tree


def _stream():
    return torch.cuda.current_stream().cuda_stream


def _call(fn, *args):
    err = fn(*args, _stream())
    if err != 0:
        raise RuntimeError(f"old kernel launch failed: CUDA error {err}")


def _measure(fn):
    return {"ms": cs._median_ms(fn), "dev_ms": cs._device_ms(fn)}


def _ab(name, old, new, plain, library, bound, check):
    """old, new, new, old; then plain and library once. ``check`` holds
    both kernels against the plain version first."""
    check()
    runs = {"old": [], "new": []}
    for who in ("old", "new", "new", "old"):
        runs[who].append(_measure(old if who == "old" else new))
    res = {"old": runs["old"], "new": runs["new"], "plain": _measure(plain),
           "library": None if library is None else _measure(library),
           "bound_ms": bound.ms, "bound_by": bound.by}
    old_dev = [r["dev_ms"] for r in runs["old"]]
    new_dev = [r["dev_ms"] for r in runs["new"]]
    lib = res["library"]
    print(f"[ab] {name}: device ms old {old_dev} new {new_dev} plain "
          f"{res['plain']['dev_ms']} library "
          f"{None if lib is None else lib['dev_ms']} bound {bound.ms:.5f} "
          f"({bound.by}) | per call ms old "
          f"{[r['ms'] for r in runs['old']]} new "
          f"{[r['ms'] for r in runs['new']]} plain {res['plain']['ms']} "
          f"library {None if lib is None else lib['ms']}", flush=True)
    return res


def _close(what, got, want):
    torch.cuda.synchronize()
    if not torch.allclose(got, want, rtol=cs.SPD_RTOL, atol=cs.SPD_ATOL):
        raise AssertionError(f"{what} disagrees with the plain version: max "
                             f"abs err {float((got - want).abs().max())}")


def spd_ab(old, n, N):
    At, bt = cs._spd_inputs(n, N, seed=n)
    Lp = sk._chol_lanes_factor(At)
    A = At.permute(2, 0, 1).contiguous()
    L = Lp.permute(2, 1, 0).contiguous()
    b = bt.T.contiguous()[..., None]

    def old_factor():
        Lt = torch.empty_like(At)
        _call(old.spd_factor_lanes_f32, At.data_ptr(), Lt.data_ptr(), n, N)
        return Lt

    def old_sub():
        x = torch.empty_like(bt)
        _call(old.spd_substitute_lanes_f32, Lp.data_ptr(), bt.data_ptr(),
              x.data_ptr(), n, 1, N)
        return x

    def old_solve():
        x = torch.empty_like(bt)
        _call(old.spd_solve_lanes_f32, At.data_ptr(), bt.data_ptr(),
              x.data_ptr(), n, N)
        return x

    def check(o, nw, p):
        def run():
            _close("old", o(), p())
            _close("new", nw(), p())
        return run

    def new_factor():
        return sk.spd_factor_lanes_cuda(At)

    def new_sub():
        return sk.spd_substitute_lanes_cuda(Lp, bt)

    def new_solve():
        return sk.spd_solve_lanes_cuda(At, bt)

    def plain_factor():
        return sk._chol_lanes_factor(At)

    def plain_sub():
        return sk._chol_lanes_substitute(Lp, bt)

    def plain_solve():
        return sk._chol_lanes_core(At, bt)
    shape = f"(n {n}, N {N})"
    return {
        "spd_factor_lanes": _ab(
            f"spd_factor_lanes {shape}", old_factor, new_factor, plain_factor,
            lambda: torch.linalg.cholesky_ex(A), bounds.spd_factor(n, N),
            check(old_factor, new_factor, plain_factor)),
        "spd_substitute_lanes": _ab(
            f"spd_substitute_lanes K=1 {shape}", old_sub, new_sub, plain_sub,
            lambda: torch.cholesky_solve(b, L), bounds.spd_substitute(n, N),
            check(old_sub, new_sub, plain_sub)),
        "spd_solve_lanes": _ab(
            f"spd_solve_lanes {shape}", old_solve, new_solve, plain_solve,
            lambda: torch.linalg.solve(A, b), bounds.spd_solve(n, N),
            check(old_solve, new_solve, plain_solve)),
    }


def tree_ab(old, tree, N):
    chains = cs._tree_chains(tree)
    tt = ts.tree_tables(chains)
    Mp, At, b, _ = cs._tree_inputs(chains, N)
    table = torch.as_tensor(np.asarray(tt.parent + tt.off, np.int32),
                            device="cuda:0")
    H, D = ts.ltdl_factor_plain(chains, Mp)
    A = At.permute(2, 0, 1).contiguous()
    bb = b.T.contiguous()[..., None]

    def old_factor():
        Ho, Do = torch.empty_like(Mp), Mp.new_empty(tt.nv, N)
        _call(old.tree_ltdl_factor_f32, table.data_ptr(), tt.nv, tt.E,
              Mp.data_ptr(), Ho.data_ptr(), Do.data_ptr(), N)
        return Ho, Do

    def old_sub():
        x = torch.empty_like(b)
        _call(old.tree_ltdl_substitute_f32, table.data_ptr(), tt.nv, tt.E,
              H.data_ptr(), D.data_ptr(), b.data_ptr(), x.data_ptr(), 1, N)
        return x

    def new_factor():
        return ts.ltdl_factor_cuda(chains, Mp)

    def new_sub():
        return ts.ltdl_substitute_cuda(chains, (H, D), b)

    def plain_factor():
        return ts.ltdl_factor_plain(chains, Mp, True)

    def plain_sub():
        return ts.ltdl_substitute_plain(chains, (H, D), b)

    def check_factor():
        for fn in (old_factor, new_factor):
            got = fn()
            _close("H", got[0], H)
            _close("D", got[1], D)

    def check_sub():
        _close("old", old_sub(), plain_sub())
        _close("new", new_sub(), plain_sub())

    def dense_pair():
        return torch.cholesky_solve(bb, torch.linalg.cholesky_ex(A)[0])
    shape = f"({tree}: nv {tt.nv}, E {tt.E}, N {N}; {ts.GROUP} lanes an env)"
    res = {
        "tree_ltdl_factor": _ab(
            f"tree_ltdl_factor {shape}", old_factor, new_factor,
            plain_factor, None, bounds.tree_factor(chains, N), check_factor),
        "tree_ltdl_substitute": _ab(
            f"tree_ltdl_substitute K=1 {shape}", old_sub, new_sub, plain_sub,
            None, bounds.tree_substitute(chains, N), check_sub)}
    res["dense_pair"] = _measure(dense_pair)
    print(f"[ab] dense cholesky_ex + cholesky_solve {shape}: "
          f"{res['dense_pair']}", flush=True)
    return res


def floors():
    """What the current kernels take with (almost) no arithmetic: the SPD
    kernels at n = 1, N = 1024 (launch, one staging round trip, the
    store), and the tree factor at Humanoid's tree, N = 4096, with a
    schedule of one empty round (staging and storing its slabs only)."""
    At, bt = cs._spd_inputs(1, 1024, seed=1)
    Lt = sk.spd_factor_lanes_cuda(At)
    out = {"spd_n1": {
        "factor": _measure(lambda: sk.spd_factor_lanes_cuda(At)),
        "substitute": _measure(lambda: sk.spd_substitute_lanes_cuda(Lt, bt)),
        "solve": _measure(lambda: sk.spd_solve_lanes_cuda(At, bt))}}
    chains = cs._tree_chains("humanoid")
    tt = ts.tree_tables(chains)
    Mp = cs._tree_inputs(chains, 4096)[0]
    H, D = torch.empty_like(Mp), Mp.new_empty(tt.nv, 4096)
    down = ts.back_rounds(tt)
    begin, entries = ts.contributions(tt)
    empty = np.concatenate([
        tt.off, tt.anc, down.ravel(), [ts._FIRST_ROUND | ts._LAST_ROUND],
        np.full(ts.GROUP, -1), begin, entries]).astype(np.int32)
    table = torch.as_tensor(empty, device="cuda:0")
    fn = launch.entry_fn("tree_ltdl_factor")
    out["tree_factor_no_rounds"] = _measure(lambda: _call(
        fn, table.data_ptr(), table.numel(), tt.nv, tt.E, len(down), 1,
        Mp.data_ptr(), H.data_ptr(), D.data_ptr(), 4096))
    print(f"[ab] floors: {out}", flush=True)
    return out


def tree_same(old_dir):
    """The current tree kernels against an older source of the same C
    interface: bit for bit, then timed in turns."""
    old = _build_old(old_dir, "tree_ltdl")
    launch.load("tree_ltdl")
    launch.bind("tree_ltdl", old)
    out = {}
    for tree, N in TREE_SAME:
        chains = cs._tree_chains(tree)
        tt = ts.tree_tables(chains)
        table = ts._table_args(tt, torch.device("cuda:0"))
        Mp, _, b, bk = cs._tree_inputs(chains, N)
        H, D = ts.ltdl_factor_plain(chains, Mp)

        def old_factor():
            Ho, Do = torch.empty_like(Mp), Mp.new_empty(tt.nv, N)
            _call(old.tree_ltdl_factor_f32, *table, Mp.data_ptr(),
                  Ho.data_ptr(), Do.data_ptr(), N)
            return Ho, Do

        def old_sub(rhs=b):
            x = torch.empty_like(rhs)
            k = rhs.shape[0] if rhs.ndim == 3 else 1
            _call(old.tree_ltdl_substitute_f32, *table, H.data_ptr(),
                  D.data_ptr(), rhs.data_ptr(), x.data_ptr(), k, N)
            return x

        def new_sub(rhs=b):
            return ts.ltdl_substitute_cuda(chains, (H, D), rhs)
        same = {"factor": all(torch.equal(o, n) for o, n in zip(
                    old_factor(), ts.ltdl_factor_cuda(chains, Mp))),
                "substitute K=1": torch.equal(old_sub(b), new_sub(b)),
                f"substitute K={cs.TREE_RHS}": torch.equal(old_sub(bk),
                                                           new_sub(bk))}
        torch.cuda.synchronize()
        shape = f"({tree}: nv {tt.nv}, E {tt.E}, N {N})"
        print(f"[ab] tree kernels {shape} old source vs new, bit for bit: "
              f"{same}", flush=True)
        if not all(same.values()):
            raise AssertionError(f"the tree kernels changed results at "
                                 f"{shape}: {same}")
        res = _ab(f"tree_ltdl_substitute K=1 {shape}", old_sub, new_sub,
                  lambda: ts.ltdl_substitute_plain(chains, (H, D), b), None,
                  bounds.tree_substitute(chains, N), lambda: None)
        out[f"{tree} N={N}"] = {"bit_for_bit": same, "substitute": res}
    return out


def _half_builds(old_dir):
    """The old tree_ltdl.cu and csrc/tree_half.cu's variants, built in
    parallel, their half-solve entries (and the old substitute) bound
    through the package's table."""
    src = os.path.join(build.CSRC_DIR, "tree_half.cu")
    with concurrent.futures.ThreadPoolExecutor(len(HALF_VARIANTS) + 3) as pool:
        old = pool.submit(_build_old, old_dir, "tree_ltdl")
        variants = {name: pool.submit(_build_old, old_dir, "tree_half", src,
                                      name, flags)
                    for name, flags in HALF_VARIANTS.items()}
        new = [pool.submit(launch.load, lib)
               for lib in ("tree_ltdl", "tree_half")]
        old = old.result()
        for f in new:
            f.result()
        variants = {name: f.result() for name, f in variants.items()}
    for lib in variants.values():
        launch.bind("tree_half", lib)
    launch.bind("tree_half", old, ("tree_ltdl_upsolve", "tree_ltdl_downsolve"))
    launch.bind("tree_ltdl", old, ("tree_ltdl_substitute",))
    return old, variants


def _half_input(tree, N, K):
    """chip_smoke.py's half-solve inputs: H from the factor kernel, b
    (K, nv, N), or (nv, N) at K = 1."""
    chains = cs._tree_chains(tree)
    Mp = cs._tree_inputs(chains, N)[0]
    H, _ = ts.ltdl_factor_cuda(chains, Mp)
    b = torch.randn(K, len(chains), N, device=H.device,
                    generator=torch.Generator(device=H.device).manual_seed(K))
    return chains, H, b[0] if K == 1 else b


def half_same(old_dir):
    """csrc/tree_half.cu against the old half-solves and the current
    substitute against the old one: bit for bit, then timed in turns."""
    old, variants = _half_builds(old_dir)
    dev = torch.device("cuda:0")
    out = {"bit_for_bit": {}, "times": {}, "plans": {}}
    for tree, N, K in HALF_SAME:
        chains, H, b = _half_input(tree, N, K)
        tt = ts.tree_tables(chains)
        args = ts._table_args(tt, dev)
        shape = f"({tree}: nv {tt.nv}, E {tt.E}, N {N}, K {K})"

        def run(fn, entry):
            x = torch.empty_like(b)
            _call(fn, *args, H.data_ptr(), b.data_ptr(), x.data_ptr(), K, N)
            return x
        same, timed = {}, {}
        for entry in ("upsolve", "downsolve"):
            name = f"tree_ltdl_{entry}_f32"
            want = run(getattr(old, name), entry)
            new = getattr(ts, f"ltdl_{entry}_cuda")
            same[entry] = torch.equal(new(chains, H, b), want)
            for v, lib in variants.items():
                same[f"{entry} {v}"] = torch.equal(
                    run(getattr(lib, name), entry), want)
            if (tree, N, K) in HALF_TIMED:
                # At K = 1 every Kb is 1: the variants are the new entry.
                sweep = variants if K > 1 else {}
                fns = {"old": lambda f=getattr(old, name): run(f, entry),
                       "new": lambda: new(chains, H, b),
                       **{v: (lambda f=getattr(lib, name): run(f, entry))
                          for v, lib in sweep.items()}}
                order = ["old", "new", *sweep]
                runs = {who: [] for who in order}
                for who in order + order[::-1]:
                    runs[who].append(_measure(fns[who]))
                timed[entry] = runs
                dev_ms = {who: [r["dev_ms"] for r in rs]
                          for who, rs in runs.items()}
                print(f"[ab] tree_ltdl_{entry} {shape} device ms per call "
                      f"(turns old, new, variants, reversed): {dev_ms}",
                      flush=True)
        torch.cuda.synchronize()
        print(f"[ab] half-solves {shape} vs the old kernels, bit for bit: "
              f"{same}", flush=True)
        out["bit_for_bit"][shape] = same
        out["plans"][shape] = ts.half_plan_cuda(tt.nv, tt.E, K, N)
        if timed:
            out["times"][shape] = timed
        if not all(same.values()):
            raise AssertionError(f"the half-solves changed results at "
                                 f"{shape}: {same}")
    for tree, N in SUB_SAME:
        chains = cs._tree_chains(tree)
        tt = ts.tree_tables(chains)
        args = ts._table_args(tt, dev)
        Mp, _, b, bk = cs._tree_inputs(chains, N)
        H, D = ts.ltdl_factor_cuda(chains, Mp)

        def old_sub(rhs):
            x = torch.empty_like(rhs)
            k = rhs.shape[0] if rhs.ndim == 3 else 1
            _call(old.tree_ltdl_substitute_f32, *args, H.data_ptr(),
                  D.data_ptr(), rhs.data_ptr(), x.data_ptr(), k, N)
            return x
        same = {f"substitute K={1 if rhs.ndim == 2 else rhs.shape[0]}":
                torch.equal(old_sub(rhs), ts.ltdl_substitute_cuda(
                    chains, (H, D), rhs)) for rhs in (b, bk)}
        shape = f"({tree}: nv {tt.nv}, E {tt.E}, N {N})"
        print(f"[ab] substitute {shape} vs the old kernel, bit for bit: "
              f"{same}", flush=True)
        out["bit_for_bit"][shape] = same
        if not all(same.values()):
            raise AssertionError(f"the substitute changed results at "
                                 f"{shape}: {same}")
        res = _ab(f"tree_ltdl_substitute K=1 {shape}", lambda: old_sub(b),
                  lambda: ts.ltdl_substitute_cuda(chains, (H, D), b),
                  lambda: ts.ltdl_substitute_plain(chains, (H, D), b), None,
                  bounds.tree_substitute(chains, N), lambda: None)
        out["times"][f"substitute {shape}"] = res
    return out


def main(argv):
    if len(argv) == 2 and argv[0] == "--half-same":
        smi = cs.phase_device()
        out = {"card": smi, "half_same": half_same(argv[1])}
        os.makedirs(os.path.dirname(OUT_HALF), exist_ok=True)
        with open(OUT_HALF, "w") as f:
            json.dump(out, f, indent=1)
        print(f"[ab] wrote {OUT_HALF}; card {smi}")
        return
    if len(argv) == 2 and argv[0] == "--tree-same":
        smi = cs.phase_device()
        out = {"card": smi, "tree_same": tree_same(argv[1])}
        os.makedirs(os.path.dirname(OUT_SAME), exist_ok=True)
        with open(OUT_SAME, "w") as f:
            json.dump(out, f, indent=1)
        print(f"[ab] wrote {OUT_SAME}; card {smi}")
        return
    if len(argv) != 1:
        raise SystemExit(__doc__)
    smi = cs.phase_device()
    old_spd, old_tree = _old_fns(argv[0])
    out = {"card": smi,
           "spd": {f"n={n} N={N}": spd_ab(old_spd, n, N) for n, N in SPD_AB},
           "tree_humanoid": tree_ab(old_tree, "humanoid", 4096),
           "tree_ant": tree_ab(old_tree, "ant", 1024), "floors": floors()}
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(out, f, indent=1)
    print(f"[ab] wrote {OUT}; card {smi}")


if __name__ == "__main__":
    main(sys.argv[1:])
