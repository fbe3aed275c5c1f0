"""Training command line of the port.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-3b \
      --smoke --steps 50

The port of ``repro.launch.train``: the same flags, plus ``--device``
(default the card).  Random weights from seed 0, the synthetic Markov data
of ``training.data``, AdamW with 10 warmup steps decaying over ``--steps``;
a VLM's or whisper's prefix is zeros of (batch, prefix_len, d_model).  With
``--ckpt-dir`` the state ``{"params", "opt"}`` is written every 50 steps
in the background (``CheckpointManager.save_async``) and once at the end,
in the JAX package's layout (``bridge.params_to_jax``), so its
``checkpoint.load`` reads the files.  ``--dry-run`` traces the train step
of ``train_4k`` under the production mesh on fake tensors
(``launch.dryrun.run_cell``) and prints its status and roofline.
"""

from __future__ import annotations

import argparse
import time


def train_state(cfg, params, opt_state):
    """``{"params", "opt"}`` in the JAX package's layout, host tensors."""
    from repro_torch.bridge import params_to_jax

    return {"params": params_to_jax(cfg, params),
            "opt": {"m": params_to_jax(cfg, opt_state["m"]),
                    "v": params_to_jax(cfg, opt_state["v"]),
                    "step": opt_state["step"].detach().cpu()}}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config, local devices")
    ap.add_argument("--dry-run", action="store_true",
                    help="lower+compile under the production mesh")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the model (default: the card)")
    args = ap.parse_args(argv)

    if args.dry_run:
        from repro_torch.launch.dryrun import run_cell
        res = run_cell(args.arch, "train_4k", args.multi_pod, force=True)
        print(res.get("status"), res.get("roofline", res.get("error")))
        return

    import torch

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_config
    from repro_torch.models import build_model, has_prefix_embeds
    from repro_torch.models.model_zoo import prefix_len
    from repro_torch.training import (
        DataConfig,
        OptimizerConfig,
        SyntheticLMDataset,
        init_optimizer,
        make_train_step,
    )

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    model = build_model(cfg, device=args.device)
    params = model.init(0)
    print(f"{cfg.name}: {model.num_params(params) / 1e6:.1f}M params")

    opt_cfg = OptimizerConfig(warmup_steps=10, decay_steps=args.steps)
    opt_state = init_optimizer(opt_cfg, params)
    data = SyntheticLMDataset(DataConfig(vocab_size=cfg.vocab_size,
                                         seq_len=args.seq_len,
                                         global_batch=args.batch))
    step_fn = make_train_step(model, opt_cfg, microbatches=args.microbatches,
                              has_prefix=has_prefix_embeds(cfg))
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None

    t0 = time.time()
    for step in range(args.steps):
        batch = {"tokens": torch.from_numpy(data.batch(step)["tokens"])
                 .to(args.device)}
        if has_prefix_embeds(cfg):
            batch["prefix_embeds"] = torch.zeros(
                (args.batch, prefix_len(cfg), cfg.d_model), device=args.device)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss={float(metrics['loss']):.4f} "
                  f"({time.time() - t0:.0f}s)")
        if mgr and step and step % 50 == 0:
            mgr.save_async(step, train_state(cfg, params, opt_state))
    if mgr:
        mgr.wait()
        mgr.save(args.steps, train_state(cfg, params, opt_state))


if __name__ == "__main__":
    main()
