"""BayesSimIG-TPU-Torch entry point: the adaptive domain-randomization loop.

Port of ``bayes_sim_ig_tpu/bayes_sim_main.py``:

  for each ADR ("real") iteration:
    1. plot the current sim-param posterior;
    2. train PPO on envs whose params are drawn from that posterior
       (restart or finetune per ``bayessim.ftuneRL``);
    3. evaluate on the surrogate-real system (params from ``realParams``),
       log rewards + a video;
    4. (unless ``modelClass: None`` ablation) collect randomized rollouts,
       ALWAYS from the uniform prior, in 1000-trajectory chunks, training
       BayesSim on each chunk;
    5. collect surrogate-real trajectories, accumulate them across
       iterations, and set the next sampling distribution to
       ``bsim.predict(all_real_states, all_real_actions)``.

Every env and model tensor lives on ``--rl_device`` (default cuda:0).
Under ``torchrun`` with W ranks the envs are sharded over the ranks, rank r
on ``cuda:LOCAL_RANK`` (``setup_parallelism``, ``parallel/mesh.py``). The
run equals one process bit for bit on the CPU, and one card on cards but
for the rounding of the policy's GEMMs at fewer rows; rank 0 logs, plots
and writes the checkpoints.

Run:
  python -m bayes_sim_ig_tpu_torch.bayes_sim_main --task Cartpole \
      --logdir runs/bsim --max_iterations 20 --seed 0 --rl_device cuda:0
  torchrun --nproc_per_node 4 -m bayes_sim_ig_tpu_torch.bayes_sim_main \
      --task Cartpole --logdir runs/bsim
"""

from __future__ import annotations

import contextlib
import os
import pickle
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

np.set_printoptions(edgeitems=30, linewidth=4000, precision=4,
                    suppress=True, threshold=10000)

from .engine import BayesSim  # noqa: E402
from .parallel import (auto_mesh, initialize_distributed,  # noqa: E402
                       is_main_process, local_device, set_global_mesh,
                       sync_host_rng)
from .distributions import pdf, to_device_distr  # noqa: E402
from .rl import process_ppo  # noqa: E402
from .sim import make_env  # noqa: E402
from .utils.args import (init_args, log_args, check_distr,  # noqa: E402
                         load_real_params)
from .utils.collect import (collect_trajectories,  # noqa: E402
                            get_collect_policy)
from .utils.convert import (mdnn_params_from_jax,  # noqa: E402
                            mdnn_params_to_jax)
from .utils import trace  # noqa: E402


class _NullWriter:
    """Stands in for a TensorBoard writer when no writer package exists."""

    def __getattr__(self, name):
        return lambda *args, **kwargs: None


_NOTICES: set = set()


def _notice_once(msg):
    if msg not in _NOTICES:
        _NOTICES.add(msg)
        print(msg)


def _make_writer(logdir, sub="bsim"):
    """tensorboardX's writer, else PyTorch's own, else a no-op (always on
    ranks other than 0)."""
    if not is_main_process():
        return _NullWriter()
    try:
        from tensorboardX import SummaryWriter
    except ImportError:
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            _notice_once("Neither tensorboardX nor tensorboard is "
                         "installed: TensorBoard logging is off.")
            return _NullWriter()
    return SummaryWriter(os.path.join(logdir, sub), flush_secs=10)


def _plot_posterior(writer, step, spec, real_params_distr, posterior):
    if not is_main_process():
        return
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        _notice_once("matplotlib is not installed: posterior plots are "
                     "off.")
        return
    from .utils import plot
    plot.plot_posterior(
        writer, "BayesSim/posterior", step,
        sim_params_names=spec.names, skip_ids=spec.skip_ids,
        true_params=real_params_distr.components[0].m,
        posterior=posterior, p_lower=spec.lows, p_upper=spec.highs)


def _start_profile():
    """Starts a ``torch.profiler`` trace with the port's tracing on, so
    that the trace holds the program's spans; returns (profiler, whether
    tracing was on before)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.start()
    was_on = trace.ENABLED
    trace.enable()
    return prof, was_on


def _stop_profile(profiling, logdir):
    """Stops the trace and writes it; tracing that ``--profile`` turned on
    goes off again, and its records go (the trace holds the spans)."""
    prof, was_on = profiling
    if not was_on:
        trace.disable()
    prof.stop()
    if not was_on:
        trace.reset()
    out = os.path.join(logdir, "profile")
    os.makedirs(out, exist_ok=True)
    prof.export_chrome_trace(os.path.join(out, "trace.json"))
    print("Wrote torch.profiler trace to", out)


def setup_parallelism(num_envs, device="cuda"):
    """Multi-GPU bring-up for the ADR loop: joins the process group that
    ``torchrun`` describes (NCCL for a CUDA ``device``, gloo for the CPU),
    then installs a 1-D env mesh over all its ranks as the global mesh
    (``parallel/mesh.py``; raises if they do not divide ``numEnvs``): each
    rank then steps its slice of the envs and gathers what they produce.
    Returns the mesh (None = a single device)."""
    device = torch.device(device)
    initialize_distributed(backend="nccl" if device.type == "cuda"
                           else "gloo")
    if device.type == "cuda" and dist.is_initialized():
        torch.cuda.set_device(local_device(device))
    mesh = auto_mesh(num_envs)
    set_global_mesh(mesh)
    sync_host_rng()
    if mesh is not None:
        print(f"Parallelism: sharding {num_envs} envs over {mesh.size} "
              f"ranks (1-D env mesh), this is rank {mesh.rank} on "
              f"{local_device(device)}")
    else:
        count = (torch.cuda.device_count() if device.type == "cuda"
                 else 1)
        print(f"Parallelism: single device ({count} visible)")
    return mesh


def main(argv=None):
    """Runs the ADR loop; returns a dict with the final ``bsim``, ``ppo``,
    ``env``, ``posterior``, the run's ``logdir``, the seconds of each
    ADR iteration (``iter_secs``; none under ``modelClass: None``) and the
    surrogate-real evaluation of each (``real_rewards``: its ``mean``,
    ``min`` and ``max``, as logged under ``SurrogateReal/``). Ranks other
    than 0 print nothing."""
    args, cfg_env, cfg_train = init_args(argv)
    had_group = dist.is_available() and dist.is_initialized()
    num_envs = int(cfg_env["env"]["numEnvs"])
    mesh = setup_parallelism(num_envs, args.rl_device)
    try:
        if mesh is not None:
            # This rank builds and steps its own slice of the envs.
            cfg_env["env"]["numEnvs"] = num_envs // mesh.size
        with contextlib.ExitStack() as stack:
            if not is_main_process():
                stack.enter_context(contextlib.redirect_stdout(
                    stack.enter_context(open(os.devnull, "w"))))
            return _adr_loop(args, cfg_env, cfg_train,
                             local_device(args.rl_device))
    finally:
        set_global_mesh(None)
        if not had_group and dist.is_initialized():
            dist.destroy_process_group()


def _adr_loop(args, cfg_env, cfg_train, device):
    env = make_env(args.task, cfg_env, seed=args.seed, device=device)
    spec = env.task.params_spec
    print(spec.describe())

    # Real and sim parameter distributions.
    real_w, real_m, real_s = load_real_params(cfg_env, spec.dim)
    real_params_distr = pdf.MoG(a=real_w, ms=real_m, Ss=real_s)
    check_distr(real_params_distr, spec.lows, spec.highs, "realParams")
    print("Init real_params_distr", real_params_distr)
    sim_params_distr = pdf.Uniform(spec.lows, spec.highs)  # the prior
    print("Init sim_params_distr", sim_params_distr)

    def set_env_distr(distr):
        env.set_distr(to_device_distr(distr, spec.lows, spec.highs,
                                      device=device))

    writer = _make_writer(args.logdir)
    log_args(args, cfg_env, cfg_train, writer)

    bs_cfg = cfg_env["bayessim"]
    ftune_rl = bs_cfg["ftuneRL"]
    set_env_distr(sim_params_distr)
    # RL curves live in their own TB run dirs (rl_<iter> when restarting,
    # one run when finetuning).
    rl_writer = _make_writer(args.logdir, "rl" if ftune_rl else "rl_0")
    ppo = process_ppo(env, cfg_train,
                      args.logdir if ftune_rl
                      else os.path.join(args.logdir, "rl_0"),
                      writer=rl_writer, seed=args.seed)
    if "policyCheckpt" in bs_cfg:
        ppo.load(bs_cfg["policyCheckpt"])
    collect_policy_fxn = get_collect_policy(bs_cfg["collectPolicy"],
                                            task=env.task)

    def new_bsim():
        return BayesSim(
            model_cfg=bs_cfg, obs_dim=env.task.obs_dim,
            act_dim=env.task.act_dim, params_dim=spec.dim,
            params_lows=spec.lows, params_highs=spec.highs, prior=None,
            proposal=None, seed=args.seed, device=device)

    bsim = None
    n_train_trajs = bs_cfg["trainTrajs"]
    all_real_states = None
    all_real_actions = None

    # Resume the outer loop from the latest per-iteration checkpoint.
    start_iter = 0
    if getattr(args, "resume", False):
        resumed = _load_latest_checkpoint(args.logdir, ppo)
        if resumed is not None:
            start_iter = resumed["real_iter_id"] + 1
            sim_params_distr = pdf.MoG(
                a=resumed["weights"], ms=list(resumed["means"]),
                Ss=list(resumed["covs"]))
            all_real_states = resumed.get("all_real_states")
            all_real_actions = resumed.get("all_real_actions")
            if (all_real_states is not None
                    and np.ndim(all_real_states) == 0):
                all_real_states = all_real_actions = None
            # With ftune the BayesSim model accumulates across iterations:
            # restore it too.
            if (bs_cfg["ftune"] and bs_cfg["modelClass"] != "None"
                    and resumed.get("bsim_model") is not None):
                bsim = new_bsim()
                bsim.model.net.load_state_dict(
                    mdnn_params_from_jax(resumed["bsim_model"]))
                if resumed.get("bsim_coeff") is not None:
                    bsim.model.rff.coeff.copy_(
                        torch.from_numpy(resumed["bsim_coeff"]))
                print("Restored the ftuned BayesSim model")
            print(f"Resumed from iteration {start_iter - 1}; "
                  f"continuing at {start_iter}")

    profile_iter = (start_iter if getattr(args, "profile", False)
                    and is_main_process() else None)
    iter_secs_all = []
    real_rewards_all = []

    def iteration(real_iter_id):
        """One ADR iteration up to its new posterior; False where the
        config is pure DR (``modelClass: None``), which fits nothing."""
        nonlocal rl_writer, bsim, sim_params_distr
        nonlocal all_real_states, all_real_actions
        _plot_posterior(writer, real_iter_id, spec, real_params_distr,
                        sim_params_distr)

        # ---- Train RL on the current posterior. ---------------------- #
        print("============= Train RL before real_iter_id", real_iter_id)
        with trace.span("adr.rl"):
            set_env_distr(sim_params_distr)
            if not ftune_rl and real_iter_id > 0:
                # Restart RL from scratch by re-initializing the trainer.
                ppo_logdir = os.path.join(args.logdir, f"rl_{real_iter_id}")
                rl_writer.close()
                rl_writer = _make_writer(args.logdir, f"rl_{real_iter_id}")
                ppo.reinit(seed=args.seed + real_iter_id, logdir=ppo_logdir,
                           writer=rl_writer)
                ppo.run(num_learning_iterations=args.max_iterations,
                        log_interval=cfg_train["learn"].get("save_interval",
                                                            50))
            else:
                ppo_it = real_iter_id * args.max_iterations
                ppo.current_learning_iteration = ppo_it
                ppo.run(num_learning_iterations=ppo_it + args.max_iterations,
                        log_interval=cfg_train["learn"].get("save_interval",
                                                            50))

        # ---- Surrogate-real evaluation. ------------------------------ #
        print("Simulating evals...")
        with trace.span("adr.evaluate"):
            set_env_distr(real_params_distr)
            _, _, _, real_rwds, real_imgs = collect_trajectories(
                bs_cfg["realEvals"], ppo, None, max_traj_len=None,
                visualize=True)
            real_rwds = real_rwds.cpu().numpy()
            real_rewards = {fxn: float(getattr(np, fxn)(real_rwds))
                            for fxn in ("mean", "min", "max")}
        real_rewards_all.append(real_rewards)
        for fxn, value in real_rewards.items():
            writer.add_scalar("SurrogateReal/real_rewards_" + fxn, value,
                              real_iter_id)
        _write_video(writer, real_imgs, real_iter_id)
        if bs_cfg["modelClass"] == "None":
            return False

        # ---- Collect randomized rollouts, train BayesSim. ------------ #
        print(f"Start BayesSim {bs_cfg['modelClass']} iter {real_iter_id}")
        set_env_distr(pdf.Uniform(spec.lows, spec.highs))  # always prior
        if bsim is None or not bs_cfg["ftune"]:
            if bsim is not None:
                bsim.free_graphs()
            bsim = new_bsim()
        n_trajs_done = 0
        log_bsim = None
        print("Will train BayesSim on", n_train_trajs, "trajs")
        chunk = 0
        while n_trajs_done < n_train_trajs:
            n_batch = BayesSim.get_n_trajs_per_batch(n_train_trajs,
                                                     n_trajs_done)
            with trace.span("adr.collect_train", chunk=chunk):
                sim_prms, sim_states, sim_acts, *_ = collect_trajectories(
                    n_batch, ppo, collect_policy_fxn,
                    max_traj_len=bs_cfg["trainTrajLen"])
            with trace.span("adr.fit", chunk=chunk):
                log_bsim = bsim.run_training(sim_prms, sim_states, sim_acts)
            n_trajs_done += n_batch
            chunk += 1
            print(f"n_trajs_done {n_trajs_done} (of {n_train_trajs}) "
                  f"loss train {log_bsim['train_loss'][-1]:.4f} "
                  f"test {log_bsim['test_loss'][-1]:.4f}")
        writer.add_scalar("BayesSim/train_loss",
                          log_bsim["train_loss"][-1], real_iter_id)
        writer.add_scalar("BayesSim/test_loss",
                          log_bsim["test_loss"][-1], real_iter_id)
        writer.flush()
        sys.stdout.flush()

        # ---- Surrogate-real trajectories -> new posterior. ----------- #
        print("Simulating surrogate real runs...")
        with trace.span("adr.collect_real"):
            set_env_distr(real_params_distr)
            _, real_states, real_actions, *_ = collect_trajectories(
                bs_cfg["realTrajs"], ppo, collect_policy_fxn,
                max_traj_len=bs_cfg["trainTrajLen"])
            real_states = real_states.cpu().numpy()
            real_actions = real_actions.cpu().numpy()
        if all_real_states is None:
            all_real_states, all_real_actions = real_states, real_actions
        else:
            all_real_states = np.concatenate([all_real_states, real_states])
            all_real_actions = np.concatenate(
                [all_real_actions, real_actions])
        with trace.span("adr.posterior"):
            sim_params_distr = bsim.predict(all_real_states,
                                            all_real_actions)
        return True

    for real_iter_id in range(start_iter, bs_cfg["realIters"]):
        t_iter = time.time()
        prof = _start_profile() if real_iter_id == profile_iter else None
        with trace.span("adr.iteration", iteration=real_iter_id):
            fitted = iteration(real_iter_id)
        if prof is not None:
            _stop_profile(prof, args.logdir)
        if not fitted:
            continue  # Ablation: pure DR without BayesSim.
        iter_secs = time.time() - t_iter
        iter_secs_all.append(iter_secs)
        writer.add_scalar("perf/sec_per_adr_iter", iter_secs, real_iter_id)
        print(f"Iter {real_iter_id} took {iter_secs:.1f}s; "
              f"posterior:\n{sim_params_distr}")
        if is_main_process():
            _save_iteration_checkpoint(
                args.logdir, real_iter_id, sim_params_distr, ppo,
                all_real_states, all_real_actions,
                bsim=bsim if bs_cfg["ftune"] else None)
    # The ADR phase ends: its captured steps, updates and fits and their
    # memory go.
    if bsim is not None:
        bsim.free_graphs()
    ppo.free_update_graphs()
    env.free_step_graphs()
    writer.close()
    rl_writer.close()
    return {"bsim": bsim, "ppo": ppo, "env": env,
            "posterior": sim_params_distr, "logdir": args.logdir,
            "iter_secs": iter_secs_all, "real_rewards": real_rewards_all}


def _write_video(writer, imgs, step):
    """Surrogate-real rollout video at 24 fps; start/middle/end frames when
    moviepy is unavailable."""
    if len(imgs) == 0:
        return
    try:
        import moviepy  # noqa: F401  (the writers' video dependency)
        vid = np.stack(imgs)[None].transpose(0, 1, 4, 2, 3)
        writer.add_video("RealSurrogate/video", vid, step, fps=24)
    except ImportError:
        for tag, idx in (("start", 0), ("mid", len(imgs) // 2),
                         ("end", len(imgs) - 1)):
            frame = np.transpose(imgs[idx], (2, 0, 1))
            writer.add_image(f"RealSurrogate/frame_{tag}", frame, step)


def _save_iteration_checkpoint(logdir, real_iter_id, posterior, ppo,
                               all_real_states=None,
                               all_real_actions=None, bsim=None):
    """Posterior + policy + real-trajectory accumulator (+ ftuned BayesSim
    model, in the JAX package's numpy layout) checkpoint per ADR
    iteration, for outer-loop resume."""
    path = os.path.join(logdir, "checkpoints")
    os.makedirs(path, exist_ok=True)
    rff = None if bsim is None else getattr(bsim.model, "rff", None)
    with open(os.path.join(path, f"posterior_{real_iter_id}.pkl"),
              "wb") as f:
        pickle.dump({
            "weights": np.asarray(posterior.a),
            "means": np.stack([g.m for g in posterior.xs]),
            "covs": np.stack([g.S for g in posterior.xs]),
            "real_iter_id": real_iter_id,
            "all_real_states": None if all_real_states is None
            else np.asarray(all_real_states),
            "all_real_actions": None if all_real_actions is None
            else np.asarray(all_real_actions),
            "bsim_model": None if bsim is None
            else mdnn_params_to_jax(bsim.model.net),
            "bsim_coeff": None if rff is None
            else rff.coeff.cpu().numpy(),
        }, f)
    ppo.save(os.path.join(path, f"policy_{real_iter_id}.ckpt"))


def _load_latest_checkpoint(logdir, ppo):
    """Finds the newest posterior_<N>.pkl under logdir/checkpoints, loads
    it and the matching policy; returns the payload or None."""
    import glob
    path = os.path.join(logdir, "checkpoints")
    files = glob.glob(os.path.join(path, "posterior_*.pkl"))
    if not files:
        return None
    latest = max(files, key=lambda f: int(
        os.path.splitext(os.path.basename(f))[0].split("_")[1]))
    with open(latest, "rb") as f:
        payload = pickle.load(f)
    policy = os.path.join(path, f"policy_{payload['real_iter_id']}.ckpt")
    if os.path.exists(policy):
        ppo.load(policy)
    return payload


if __name__ == "__main__":
    main()
