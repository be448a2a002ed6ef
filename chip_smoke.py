"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits non-zero):
  1. device: requires CUDA, prints the card's name and power limit;
  2. build: compiles the port's CUDA kernels from csrc/ (nvcc);
  3. kernel vs plain: each kernel against its plain PyTorch version on the
     card at the main path's shapes, with the stated tolerance; the median
     time per call of both over 50 calls (CUDA events), and their device
     time per call (torch.profiler);
  4. the ADR loop: Cartpole + MDRFF at full width (512 envs, summary_corrdiff
     features d = 302, 200 RFF features, 10 components over 13 params)
     for 2 ADR iterations through ``bayes_sim_main.main``, then checks that
     the kernels were launched, the posteriors are finite and every model
     and env tensor is on the card.
The line before the last is a JSON object with each kernel's numbers; the
last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
RUN_DIR = os.path.join(HERE, "runs", "chip_smoke")

# rtol/atol of the JAX package's own kernel test (tests/test_ops.py:31-32).
RTOL, ATOL = 2e-4, 1e-5
# (B, d, m): a training minibatch, the test split, one prediction, a whole
# chunk, and a ragged toy shape.
RFF_SHAPES = [(100, 302, 100), (200, 302, 100), (1, 302, 100),
              (1000, 302, 100), (17, 3, 64)]
TIMED_SHAPE = (100, 302, 100)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    # Full float32 for every plain product the kernels are compared with.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.device_count()} card(s)",
          flush=True)
    return smi


def phase_build():
    from bayes_sim_ig_tpu_torch.ops import build, rff_kernel
    t0 = time.perf_counter()
    rff_kernel._kernel_fn()
    secs = time.perf_counter() - t0
    log = build.BUILD_LOG.get("rff_features", {})
    ptxas = " ".join(line.strip() for line in log.get("ptxas", "").split(
        "\n") if "registers" in line or "stack frame" in line)
    print(f"[build] rff_features.cu built+loaded in {secs:.2f} s "
          f"({'compiled' if log else 'cached'}); {ptxas}", flush=True)


def _median_ms(fn, n=50, warmup=5):
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _device_ms(fn, n=50):
    """Mean device time per call of the kernels ``fn`` launches, from a
    torch.profiler trace; None when the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total_us = sum(getattr(e, "self_device_time_total", 0.0)
                   for e in prof.key_averages())
    return total_us / 1000.0 / n if total_us > 0 else None


def phase_kernel():
    from bayes_sim_ig_tpu_torch.ops import rff_kernel
    dev = torch.device("cuda:0")
    a = 0.1
    worst = 0.0
    timed = None
    for b, d, m in RFF_SHAPES:
        rs = np.random.RandomState(0)
        x = torch.as_tensor(rs.randn(b, d), dtype=torch.float32, device=dev)
        coeff = torch.as_tensor(rs.randn(d, m) * 0.3, dtype=torch.float32,
                                device=dev)
        got = rff_kernel.rff_features_cuda(x, coeff, a)
        want = rff_kernel.rff_features_reference(x, coeff, a)
        torch.cuda.synchronize()
        assert got.shape == (b, 2 * m) and torch.isfinite(got).all()
        err = (got - want).abs()
        max_abs = float(err.max())
        max_rel = float((err / want.abs().clamp_min(1e-30)).max())
        ok = bool(torch.allclose(got, want, rtol=RTOL, atol=ATOL))
        k_ms = _median_ms(lambda: rff_kernel.rff_features_cuda(x, coeff, a))
        p_ms = _median_ms(
            lambda: rff_kernel.rff_features_reference(x, coeff, a))
        k_dev = _device_ms(lambda: rff_kernel.rff_features_cuda(x, coeff, a))
        p_dev = _device_ms(
            lambda: rff_kernel.rff_features_reference(x, coeff, a))

        def fmt(v):
            return "not measured" if v is None else f"{v:.4f} ms"
        print(f"[kernel] rff_features B={b} d={d} m={m}: max_abs_err "
              f"{max_abs:.3e} max_rel_err {max_rel:.3e} (rtol {RTOL}, atol "
              f"{ATOL}) {'ok' if ok else 'MISMATCH'} | median of 50 (CUDA "
              f"events per call): kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms "
              f"| device time per call (profiler): kernel {fmt(k_dev)}, "
              f"plain {fmt(p_dev)}", flush=True)
        if not ok:
            raise AssertionError(f"rff_features disagrees with its plain "
                                 f"version at B={b} d={d} m={m}")
        worst = max(worst, max_abs)
        if (b, d, m) == TIMED_SHAPE:
            timed = (k_ms, p_ms)
    return {"max_abs_err": worst, "ms": timed[0], "plain_ms": timed[1]}


def _on_cuda(tensors, what):
    bad = [tuple(t.shape) for t in tensors if t.device.type != "cuda"]
    if bad:
        raise AssertionError(f"{what}: tensors off the card: {bad}")


def phase_adr():
    from bayes_sim_ig_tpu_torch import bayes_sim_main
    from bayes_sim_ig_tpu_torch.ops import rff_kernel
    from bayes_sim_ig_tpu_torch.utils.args import load_config
    shutil.rmtree(RUN_DIR, ignore_errors=True)
    os.makedirs(RUN_DIR)
    cfg = load_config(os.path.join(HERE, "bayes_sim_ig_tpu_torch", "cfg",
                                   "cartpole.yaml"))
    cfg["bayessim"].update(modelClass="MDRFF", trainTrajs=2000, realIters=2)
    assert cfg["env"]["numEnvs"] == 512
    assert cfg["bayessim"]["trainTrajLen"] == 20
    assert cfg["bayessim"]["components"] == 10
    cfg_path = os.path.join(RUN_DIR, "cartpole_mdrff.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    argv = ["--task", "Cartpole", "--cfg_env", cfg_path, "--logdir",
            os.path.join(RUN_DIR, "logs"), "--max_iterations", "5",
            "--seed", "0", "--rl_device", "cuda:0"]
    rff_kernel.LAUNCHES = 0
    t0 = time.perf_counter()
    out = bayes_sim_main.main(argv)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    launches = rff_kernel.LAUNCHES

    if launches <= 0:
        raise AssertionError("the ADR loop never launched rff_features")
    model = out["bsim"].model
    assert type(model).__name__ == "MDRFF"
    assert tuple(model.rff.coeff.shape) == (302, 100), model.rff.coeff.shape
    assert tuple(model.net.mu.weight.shape) == (130, 200)
    _on_cuda(list(model.net.parameters()) + [model.rff.coeff], "MDRFF")
    _on_cuda(list(out["bsim"]._refit_model.net.parameters()), "refit MDNN")
    _on_cuda(list(out["ppo"].net.parameters()), "PPO policy")
    st = out["env"].state
    _on_cuda(list(st.task_state) + [st.params, st.progress, st.reset_buf,
                                    st.obs_corr, st.act_corr], "env state")
    ckpt = os.path.join(out["logdir"], "checkpoints")
    for it in (0, 1):
        with open(os.path.join(ckpt, f"posterior_{it}.pkl"), "rb") as f:
            post = pickle.load(f)
        for k in ("weights", "means", "covs"):
            if not np.isfinite(post[k]).all():
                raise AssertionError(f"posterior_{it} {k} is not finite")
        assert post["means"].shape[1] == 13, post["means"].shape
    iter_secs = out["iter_secs"]
    assert len(iter_secs) == 2
    print(f"[adr] Cartpole+MDRFF 512 envs, 2 ADR iterations in {secs:.2f} s"
          f" (per iteration: {', '.join(f'{s:.2f}' for s in iter_secs)} s);"
          f" rff_features launches {launches}; posteriors finite; model, "
          f"refit, policy and env tensors on cuda", flush=True)
    return launches, iter_secs


def main():
    smi = phase_device()
    phase_build()
    kern = phase_kernel()
    launches, _ = phase_adr()
    print(json.dumps({"kernels": [{
        "name": "rff_features", "route": "cuda",
        "source": "bayes_sim_ig_tpu_torch/csrc/rff_features.cu",
        "replaces": "bayes_sim_ig_tpu/ops/rff_kernel.py:50",
        "launches": launches, "max_abs_err": kern["max_abs_err"],
        "ms": kern["ms"], "plain_ms": kern["plain_ms"]}]}))
    print(f"[card] {smi}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
