"""Training step factory: loss, microbatched gradient accumulation, AdamW.

The port of ``repro.training.train_loop``.  Gradients come from
``torch.autograd.grad`` over the flattened parameter leaves, the step is
eager (the counterpart of ``jax.jit`` belongs to the compiled paths, not to
this module).  The kernels of ``kernels/ops.py`` refuse inputs that require
grad on the card (none of them has a backward, in the JAX package either),
so a model whose ``apply`` reaches one (Mamba-2, Zamba2: the SSD scan)
trains on the CPU only; dense, MoE, VLM and whisper ``apply`` run plain
attention, as the JAX package's do, and train on both.
"""

from __future__ import annotations

from typing import Any

import torch

from .optimizer import OptimizerConfig, apply_gradients, tree_leaves, tree_map

Params = Any


def lm_loss(model, params, tokens, prefix_embeds=None, aux_weight: float = 0.01):
    """Next-token cross entropy (+ MoE aux loss).  Loss over text positions:
    the last S of the logits, a VLM's or whisper's prefix dropped.  The
    target's log-probability is gathered (``take_along_dim``) where the
    reference contracts a one-hot, which it does for SPMD sharding; on one
    device both give the same number, and the gather keeps no (B, S, V)
    one-hot."""
    logits, aux = model.apply(params, tokens, prefix_embeds=prefix_embeds)
    S = tokens.shape[1]
    txt = logits[:, -S:]
    logp = torch.log_softmax(txt[:, :-1].to(torch.float32), dim=-1)
    target = tokens[:, 1:, None].to(device=logp.device, dtype=torch.long)
    nll = -torch.take_along_dim(logp, target, dim=-1)[..., 0]
    return torch.mean(nll) + aux_weight * aux, (torch.mean(nll), aux)


def value_and_grad(model, params, tokens, prefix_embeds=None):
    """(loss, nll, grads) of ``lm_loss`` at ``params``; the grads share the
    tree and dtypes of ``params`` (zeros for a leaf the loss does not
    reach), the losses are 0-d float32 tensors without grad."""
    leaves = tree_leaves(params)
    live = [p.detach().requires_grad_() for p in leaves]
    it = iter(live)
    tracked = tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        loss, (nll, _) = lm_loss(model, tracked, tokens, prefix_embeds)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    it = iter(g if g is not None else torch.zeros_like(p)
              for g, p in zip(grads, leaves))
    return loss.detach(), nll.detach(), tree_map(lambda _: next(it), params)


def make_train_step(model, opt_cfg: OptimizerConfig, microbatches: int = 1,
                    has_prefix: bool = False):
    """Returns train_step(params, opt_state, batch) -> (params, opt_state,
    metrics).  ``batch`` = {"tokens": (B, S)[, "prefix_embeds": ...]}.

    With microbatches > 1 the global batch is split on the leading axis and
    the gradients are summed into a float32 tree, then divided, as the
    reference's scan does: peak activation memory drops by the microbatch
    factor while keeping one optimizer step per call.  Metrics are 0-d
    tensors (no host sync inside the step).
    """

    def train_step(params, opt_state, batch):
        tokens = batch["tokens"]
        prefix = batch.get("prefix_embeds") if has_prefix else None
        if microbatches == 1:
            loss, nll, grads = value_and_grad(model, params, tokens, prefix)
        else:
            mb = tokens.shape[0] // microbatches
            # zeros_like: a DTensor parameter's accumulator keeps its
            # placements
            grads = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                             params)
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            nll = torch.zeros_like(loss)
            for i in range(microbatches):
                rows = slice(i * mb, (i + 1) * mb)
                l, n, g = value_and_grad(
                    model, params, tokens[rows],
                    prefix[rows] if prefix is not None else None)
                tree_map(lambda acc, x: acc.add_(x), grads, g)
                loss, nll = loss + l, nll + n
            grads = tree_map(lambda g: g / microbatches, grads)
            loss, nll = loss / microbatches, nll / microbatches

        params, opt_state, om = apply_gradients(opt_cfg, params, grads,
                                                opt_state)
        metrics = {"loss": loss, "nll": nll, **om}
        return params, opt_state, metrics

    return train_step


def make_eval_step(model, has_prefix: bool = False):
    @torch.no_grad()
    def eval_step(params, batch):
        tokens = batch["tokens"]
        prefix = batch.get("prefix_embeds") if has_prefix else None
        loss, (nll, aux) = lm_loss(model, params, tokens, prefix_embeds=prefix)
        return {"loss": loss, "nll": nll}
    return eval_step
