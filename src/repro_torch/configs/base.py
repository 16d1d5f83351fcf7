"""Architecture config system (assigned public-pool architectures).

One ArchConfig fully determines parameter shapes, layer pattern, sharding
policy and input specs.  ``reduced()`` produces the CPU-smoke-test variant
(same family/topology, tiny dims).
"""
from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class MoECfg:
    n_experts: int
    top_k: int
    d_ff_expert: int
    every: int = 1               # MoE on layers where (idx % every == every-1)
    capacity_factor: float = 1.25
    shard: str = "expert"        # "expert" (E over model axis) | "ffn"


@dataclasses.dataclass(frozen=True)
class MambaCfg:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0             # 0 → ceil(d_model/16)


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | hybrid | audio | ssm | vlm
    n_layers: int
    d_model: int
    n_heads: int                 # 0 for attention-free
    n_kv_heads: int
    d_ff: int                    # dense FFN width (0 if all-MoE)
    vocab: int
    head_dim: int = 0            # 0 → d_model // n_heads
    act: str = "swiglu"          # swiglu | geglu | gelu (plain MLP)
    rope_type: Optional[str] = "std"   # std | mrope | None
    rope_theta: float = 10000.0
    mrope_sections: tuple = (16, 24, 24)
    qkv_bias: bool = False
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoECfg] = None
    # hybrid (Jamba-style): one attention layer per `attn_every` layers,
    # the rest Mamba. attn_every == 0 → all-attention.
    attn_every: int = 0
    mamba: Optional[MambaCfg] = None
    rwkv6: bool = False          # attention-free RWKV6 time/channel mix
    rwkv_head_size: int = 64
    embeddings_input: bool = False   # modality frontend stub feeds embeddings
    sub_quadratic: bool = False      # long_500k applicability
    # distribution policy
    fsdp: bool = False           # additionally shard params over 'data'
    remat: bool = True

    # ------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // max(self.n_heads, 1)

    @property
    def period(self) -> int:
        """Layer-pattern period for scan-over-blocks."""
        return self.attn_every if self.attn_every > 0 else 1

    @property
    def n_periods(self) -> int:
        assert self.n_layers % self.period == 0
        return self.n_layers // self.period

    def layer_kinds(self) -> list:
        """Kinds of the `period` sub-layers: 'attn' | 'mamba' | 'rwkv'."""
        if self.rwkv6:
            return ["rwkv"] * self.period
        if self.attn_every > 0:
            # Jamba places the attention layer mid-block (index 4 of 8 in
            # Jamba-1.5); position 0 keeps dependency simple and is
            # performance-equivalent for dry-run purposes.
            return ["attn"] + ["mamba"] * (self.period - 1)
        return ["attn"] * self.period

    def ffn_kinds(self) -> list:
        """Per sub-layer position: 'moe' | 'dense'."""
        if self.moe is None:
            return ["dense"] * self.period
        return ["moe" if (i % self.moe.every == self.moe.every - 1) else "dense"
                for i in range(self.period)]

    def param_count(self) -> float:
        """Approximate parameter count (embeddings + blocks)."""
        d, hd = self.d_model, self.resolved_head_dim
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        for kind, fkind in zip(self.layer_kinds(), self.ffn_kinds()):
            if kind == "attn":
                total += d * hd * (self.n_heads + 2 * self.n_kv_heads) \
                    + self.n_heads * hd * d
            elif kind == "mamba":
                m = self.mamba or MambaCfg()
                di = m.expand * d
                dtr = m.dt_rank or -(-d // 16)
                total += d * 2 * di + di * m.d_conv + di * (dtr + 2 * m.d_state) \
                    + dtr * di + di * m.d_state + di + di * d
            elif kind == "rwkv":
                total += 4 * d * d + d * d  # r,k,v,g,o (+ small loras elided)
            if fkind == "moe":
                total += self.moe.n_experts * 3 * d * self.moe.d_ff_expert
            elif self.d_ff:
                n_mat = 2 if self.act == "gelu" else 3
                total += n_mat * d * self.d_ff
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        per_period = total - emb          # blocks repeat n_periods times
        return emb + per_period * self.n_periods

    def active_param_count(self) -> float:
        """Active params per token (MoE: top_k of n_experts)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        moe_p = self.moe.n_experts * 3 * self.d_model * self.moe.d_ff_expert
        act_p = (self.moe.top_k + 0) * 3 * self.d_model * self.moe.d_ff_expert
        n_moe_layers = sum(1 for f in self.ffn_kinds() if f == "moe") \
            * self.n_periods
        return full - n_moe_layers * (moe_p - act_p)

    # ------------------------------------------------------------------
    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU smoke tests."""
        kw = dataclasses.asdict(self)
        kw.update(
            n_layers=self.period * 2 if self.attn_every else 2,
            d_model=64,
            n_heads=0 if self.rwkv6 else 4,
            n_kv_heads=0 if self.rwkv6 else 2,
            head_dim=16,
            d_ff=128 if self.d_ff else 0,
            vocab=256,
        )
        if self.moe is not None:
            kw["moe"] = MoECfg(n_experts=4, top_k=2, d_ff_expert=32,
                               every=self.moe.every, shard=self.moe.shard)
        else:
            kw["moe"] = None
        if self.mamba is not None:
            kw["mamba"] = MambaCfg(d_state=4, d_conv=4, expand=2, dt_rank=8)
        else:
            kw["mamba"] = None
        if self.rwkv6:
            kw["rwkv_head_size"] = 16
        kw["mrope_sections"] = (2, 3, 3)
        return ArchConfig(**kw)
