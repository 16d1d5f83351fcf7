"""Serving steps: prefill (build the KV / recurrent caches, return the
last-token logits) and decode (one token against the cache), and the
host-driven greedy loop that answers a batch of requests.  The counterpart
of ``src/repro/serve/serve_step.py``; batched requests are the batch
dimension.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..models import transformer as T


def make_prefill_step(cfg: ArchConfig, s_max: int | None = None,
                      use_kernels: bool = True):
    """prefill(params, tokens/embeds/positions) -> (last_logits, cache).
    The attention caches are padded to ``s_max`` rows (default: the prompt
    length); the Mamba (conv_buf, h) and RWKV6 states have no sequence
    axis and stay as they are.  ``use_kernels`` runs K7 / K8 on CUDA
    tensors (MoE and Mamba layers run plain PyTorch either way)."""

    def prefill(params, tokens=None, embeds=None, positions=None):
        hidden, _, caches = T.forward(cfg, params, tokens=tokens,
                                      embeds=embeds, positions=positions,
                                      collect_cache=True,
                                      use_kernels=use_kernels)
        logits = T.lm_logits(cfg, params, hidden[:, -1:, :])
        if s_max is not None:
            kinds = cfg.layer_kinds()

            def pad_kv(leaf):             # (np, B, S, Hkv, hd) → capacity
                s = leaf.shape[2]
                return F.pad(leaf, (0, 0, 0, 0, 0, s_max - s)) \
                    if s < s_max else leaf

            caches = [tuple(map(pad_kv, c)) if kinds[i] == "attn" else c
                      for i, c in enumerate(caches)]
        return logits, caches

    return prefill


def make_decode_step(cfg: ArchConfig):
    """decode(params, tokens, cache, pos, [embeds, positions]) ->
    (logits (B,1,V), cache), the cache updated in place."""

    def decode(params, tokens, cache, pos, embeds=None, positions=None):
        return T.decode_step(cfg, params, tokens, cache, pos, embeds=embeds,
                             positions=positions)

    return decode


def greedy_generate(cfg: ArchConfig, params, prompt_tokens, n_new: int,
                    use_kernels: bool = True):
    """Greedy tokens (B, n_new) for the prompts (B, S): one prefill with the
    caches padded to S + n_new rows, then n_new − 1 decode steps, the argmax
    of each step's logits fed back."""
    s = prompt_tokens.shape[1]
    prefill = make_prefill_step(cfg, s_max=s + n_new, use_kernels=use_kernels)
    decode = make_decode_step(cfg)
    logits, cache = prefill(params, tokens=prompt_tokens)
    out = [logits[:, -1, :].argmax(dim=-1)]
    pos = s
    for _ in range(n_new - 1):
        logits, cache = decode(params, out[-1][:, None], cache, pos)
        out.append(logits[:, -1, :].argmax(dim=-1))
        pos += 1
    return torch.stack(out, dim=1)
