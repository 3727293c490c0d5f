"""Model configuration dataclasses of the model zoo.

A copy of `repro.models.config` (the port imports nothing of the JAX
package).  Every architecture in ``repro_torch.configs`` instantiates a
:class:`ModelConfig`, a frozen dataclass with the reference's fields and
defaults, so one config describes the same model in both packages.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-Experts sub-config (per-layer FFN replacement)."""

    n_experts: int
    top_k: int
    d_expert: int                 # hidden dim of each expert FFN
    n_shared: int = 0             # always-on shared experts (Kimi/Llama4 style)
    capacity_factor: float = 1.25
    min_capacity: int = 4         # floor on per-expert capacity: tiny-T calls
                                  # (decode: T = B) otherwise drop tokens the
                                  # full-sequence forward keeps
    router_jitter: float = 0.0
    aux_loss_weight: float = 0.01


@dataclass(frozen=True)
class SSMConfig:
    """State-space (Mamba) sub-config."""

    kind: str = "mamba1"          # "mamba1" | "mamba2"
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64            # mamba2 only
    n_groups: int = 1             # mamba2 B/C groups
    chunk: int = 128              # chunked-scan block length
    scan_dtype: str = "float32"   # within-chunk scan element dtype
                                  # ("bfloat16" halves scan HBM traffic at
                                  # ~1e-2 relative error — opt-in)


@dataclass(frozen=True)
class ModelConfig:
    """Unified architecture description.

    family:
      dense  — decoder-only transformer
      moe    — decoder-only transformer with MoE FFN
      ssm    — attention-free Mamba stack
      hybrid — Mamba2 stack with a shared attention block every ``attn_every``
      vlm    — decoder-only transformer consuming [patch_embeds; tokens]
      audio  — encoder-decoder transformer consuming precomputed audio frames
    """

    name: str = "model"
    family: str = "dense"
    n_layers: int = 2
    d_model: int = 128
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 512
    vocab: int = 256
    head_dim: int = 0             # 0 => d_model // n_heads

    # attention details
    qkv_bias: bool = False
    rope_theta: float = 1e4
    rope_mode: str = "standard"   # "standard" | "mrope" | "none"
    mrope_sections: Tuple[int, int, int] = (2, 1, 1)   # fractions of head_dim/2 (t,h,w)
    sliding_window: int = 0       # 0 = full attention
    attn_chunk: int = 512         # q-chunk length for blocked softmax

    # norms
    norm: str = "rmsnorm"         # "rmsnorm" | "layernorm" | "nonparam_ln"
    norm_eps: float = 1e-5

    # MLP
    mlp: str = "swiglu"           # "swiglu" | "gelu"

    # family sub-configs
    moe: Optional[MoEConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_every: int = 0           # hybrid: shared attn block period (0 = never)

    # audio (encoder-decoder)
    encoder_layers: int = 0
    n_audio_frames: int = 1500

    # vlm
    n_patches: int = 0            # patch embeddings prepended to the sequence
    patch_grid: Tuple[int, int] = (16, 16)

    # numerics
    param_dtype: str = "float32"
    compute_dtype: str = "float32"
    remat: bool = True            # the reference rematerialises blocks in
                                  # training; no forward value changes, and
                                  # the port ignores it
    tie_embeddings: bool = False

    # distribution
    seq_parallel: bool = False    # on a device mesh, pin the residual
                                  # stream's seq dim on "model" (a no-op
                                  # on one device)

    # kernels
    use_flash: bool = False       # route causal self-attention through the
                                  # flash-attention kernel (K6: the CUDA
                                  # kernel on the card, its plain version
                                  # on the CPU)

    # scan grouping for hybrid (layers per scanned group between shared-attn calls)
    def derived_head_dim(self) -> int:
        return self.head_dim if self.head_dim else self.d_model // self.n_heads

    @property
    def d_inner(self) -> int:
        assert self.ssm is not None
        return self.ssm.expand * self.d_model

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def n_params(self) -> int:
        """Analytic parameter count (embeddings + blocks + head)."""
        d, v = self.d_model, self.vocab
        total = v * d  # embedding
        if not self.tie_embeddings:
            total += v * d
        hd = self.derived_head_dim()
        attn = d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads + hd * self.n_heads * d
        if self.mlp == "swiglu":
            mlp = 3 * d * self.d_ff
        else:
            mlp = 2 * d * self.d_ff
        if self.family in ("dense", "vlm"):
            total += self.n_layers * (attn + mlp)
        elif self.family == "moe":
            assert self.moe is not None
            m = self.moe
            expert = 3 * d * m.d_expert if self.mlp == "swiglu" else 2 * d * m.d_expert
            per_layer = attn + m.n_experts * expert + m.n_shared * expert + d * m.n_experts
            total += self.n_layers * per_layer
        elif self.family == "ssm":
            di = self.d_inner
            ns = self.ssm.d_state
            per = d * 2 * di + di * self.ssm.d_conv + di * (2 * ns + 2) + di * d
            total += self.n_layers * per
        elif self.family == "hybrid":
            di = self.d_inner
            ns = self.ssm.d_state
            per = d * 2 * di + di * self.ssm.d_conv + di + di * d + 2 * self.ssm.n_groups * ns * d
            total += self.n_layers * per + (attn + mlp)  # one shared attn block
        elif self.family == "audio":
            total += (self.n_layers + self.encoder_layers) * (attn + mlp)
            total += self.n_layers * attn  # cross-attention
        return total

    def active_params(self) -> int:
        """Params touched per token (MoE: only routed experts)."""
        if self.family != "moe":
            return self.n_params()
        d = self.d_model
        m = self.moe
        expert = 3 * d * m.d_expert if self.mlp == "swiglu" else 2 * d * m.d_expert
        hd = self.derived_head_dim()
        attn = d * hd * self.n_heads + 2 * d * hd * self.n_kv_heads + hd * self.n_heads * d
        per_layer = attn + (m.top_k + m.n_shared) * expert + d * m.n_experts
        total = 2 * self.vocab * d + self.n_layers * per_layer
        return total
