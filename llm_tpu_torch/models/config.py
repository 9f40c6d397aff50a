"""Model hyperparameters from GGUF metadata. Counterpart of
llm_tpu/models/config.py, for the llama family, gemma (v1) and gemma2,
baichuan and refact, qwen2 / qwen3 and the mixture-of-experts qwen2moe,
qwen3moe and mixtral, and bitnet: the general keys, rope, gemma's
adjustments (gelu, the embedding scale, NEOX rope) and gemma2's (beside
those the sliding window on every other layer, both softcaps, its
attention scale), baichuan-13B's and refact's (no rope, ALiBi with
max_bias 8), qwen2's QKV biases, qwen3's per-head qk-norm, the experts'
count, width and routing (the top-k weights normalized for llama with
experts, mixtral and qwen3moe, not for qwen2moe), bitnet's squared relu,
granite's and minicpm's embedding, residual, logit and attention scales,
olmo2's qk-norm over the whole q and k, arcee's ungated squared relu, the
RMS-norm llama graphs that differ only in their tensors (glm4, phi3,
ernie4_5, xverse, internlm2, exaone), the LayerNorm graphs (command-r,
falcon, phi2, gptneox, gptj, starcoder2, stablelm, orion, nemotron, olmo,
gpt2, starcoder, bloom, mpt: the norm kind, their act, the parallel
residual, QKV biases, olmo's norm without parameters, rope NONE with or
without ALiBi, command-r's logit scale), and the variant flags that the
port's forward refuses (it raises NotImplementedError for them, see
models/transformer.py). Every eps is read from
{arch}.attention.layer_norm_rms_epsilon, as the reference reads it (an
LN file that carries only layer_norm_epsilon runs at 1e-5 there too:
ROADMAP "Faults in the reference")."""

from __future__ import annotations

from dataclasses import dataclass, field, replace

from ..gguf.constants import Keys
from ..ops.rope import ROPE_TYPE_NEOX, ROPE_TYPE_NONE, ROPE_TYPE_NORM, RopeParams

# architectures the port's forward runs: the plain llama decoder (with
# experts: mixtral's graph), gemma's and gemma2's variants of it (gelu,
# the embedding scale; gemma2's post-norms, softcaps, interleaved SWA),
# baichuan and refact, which run the llama graph (baichuan-13B and refact
# with ALiBi in place of rope), qwen2 (QKV biases) and qwen3 (qk-norm), and
# their mixture-of-experts variants qwen2moe (with a sigmoid-gated shared
# expert) and qwen3moe, mixtral, and bitnet (a gated squared relu, RMS
# sub-norms before o_proj and ffn_down), and the RMS-norm llama graphs
# with small knobs: granite and minicpm (embedding, residual and logit
# scales), olmo2 (post-norms only, qk-norm over the whole q and k), arcee
# (an ungated squared relu), glm4 (QKV biases, post-norms, gate+up packed
# in ffn_up, half-width rope), phi3 (fused QKV, gate+up packed in ffn_up)
# and ernie4_5, xverse, internlm2 and exaone (the llama graph); and the
# LayerNorm graphs: command-r (a parallel block on one shared norm, a logit
# scale), falcon, gptj and phi2 (parallel, the FFN on the attention's
# normed input), gptneox (parallel with its own ffn_norm), starcoder2 and
# stablelm (QKV biases), orion, nemotron (an ungated squared relu), olmo
# (no norm parameters), gpt2 and starcoder (learned positions, no rope),
# bloom and mpt (ALiBi, no rope; bloom's embedding norm)
LN_ARCHS = ("command-r", "falcon", "phi2", "gptneox", "gptj", "starcoder2", "stablelm",
            "orion", "nemotron", "olmo", "gpt2", "starcoder", "bloom", "mpt")
LLAMA_ARCHS = ("llama", "gemma", "gemma2", "baichuan", "refact", "qwen2", "qwen3",
               "qwen2moe", "qwen3moe", "mixtral", "bitnet", "glm4", "granite", "minicpm",
               "olmo2", "phi3", "arcee", "ernie4_5", "xverse", "internlm2", "exaone") + LN_ARCHS
# rope layout per architecture (llm_tpu/models/config.py _ROPE_MODE, whose
# default is NEOX; refact's is then replaced by NONE)
_ROPE_MODE = {"llama": ROPE_TYPE_NORM, "gemma": ROPE_TYPE_NEOX, "gemma2": ROPE_TYPE_NEOX,
              "baichuan": ROPE_TYPE_NORM, "refact": ROPE_TYPE_NEOX, "qwen2": ROPE_TYPE_NEOX,
              "qwen3": ROPE_TYPE_NEOX, "qwen2moe": ROPE_TYPE_NEOX, "qwen3moe": ROPE_TYPE_NEOX,
              "mixtral": ROPE_TYPE_NORM, "bitnet": ROPE_TYPE_NEOX, "glm4": ROPE_TYPE_NORM,
              "granite": ROPE_TYPE_NORM, "minicpm": ROPE_TYPE_NORM, "olmo2": ROPE_TYPE_NEOX,
              "phi3": ROPE_TYPE_NEOX, "arcee": ROPE_TYPE_NORM, "ernie4_5": ROPE_TYPE_NORM,
              "xverse": ROPE_TYPE_NORM, "internlm2": ROPE_TYPE_NORM,
              "exaone": ROPE_TYPE_NEOX, "command-r": ROPE_TYPE_NORM, "falcon": ROPE_TYPE_NEOX,
              "phi2": ROPE_TYPE_NEOX, "gptneox": ROPE_TYPE_NEOX, "gptj": ROPE_TYPE_NORM,
              "starcoder2": ROPE_TYPE_NEOX, "stablelm": ROPE_TYPE_NEOX,
              "orion": ROPE_TYPE_NEOX, "nemotron": ROPE_TYPE_NEOX, "olmo": ROPE_TYPE_NORM,
              "gpt2": ROPE_TYPE_NEOX, "starcoder": ROPE_TYPE_NEOX, "bloom": ROPE_TYPE_NEOX,
              "mpt": ROPE_TYPE_NEOX}
# baichuan's 13B profile, keyed on its layer count as the reference keys it
BAICHUAN_13B_LAYERS = 40
# the ALiBi max_bias baichuan-13B and refact hardcode (llama-model.cpp)
ALIBI_MAX_BIAS = 8.0


@dataclass(frozen=True)
class ModelConfig:
    arch: str
    vocab_size: int
    n_embd: int
    n_layers: int
    n_heads: int
    n_kv_heads: int
    head_dim: int  # key length per head
    head_dim_v: int  # value length per head
    n_ff: int
    rms_eps: float = 1e-5
    rope: RopeParams = field(default_factory=lambda: RopeParams(n_dims=0))
    attn_scale: float | None = None  # None -> 1/sqrt(head_dim)
    tie_embeddings: bool = False
    norm_kind: str = "rms"  # "rms" | "ln" (LayerNorm, models/transformer.py::norm)
    act: str = "silu"
    context_length: int = 0
    # mixture of experts (models/transformer.py::moe_ffn): experts, those a
    # token takes, their FFN width; the top-k weights normalized to sum 1
    # and scaled; softmax or sigmoid router probabilities; the grouped
    # path's capacity factor (0: exact; parallel/moe.py::cap_from_cf)
    n_expert: int = 0
    n_expert_used: int = 0
    n_ff_expert: int = 0
    expert_weights_norm: bool = False
    expert_weights_scale: float = 1.0
    expert_gating_func: str = "softmax"
    ep_cf: float = 0.0
    attn_bias: bool = False  # QKV biases (qwen2, qwen2moe, starcoder2, stablelm, phi2)
    qk_norm: bool = False  # per-head RMS norm of q and k (qwen3, qwen3moe)
    qk_norm_full: bool = False  # RMS norm over the whole q and k (olmo2)
    # granite's and minicpm's scales: the embedding, the attention and FFN
    # outputs before each residual, the lm_head's logits
    embedding_scale: float = 1.0
    residual_scale: float = 1.0
    logit_scale: float = 1.0
    # the LayerNorm graphs: olmo's norms without weight or bias (even where
    # the file has no norm tensor), and the parallel block (attention and
    # FFN both read the layer's input, x + ffn + attn)
    nonparam_norm: bool = False
    parallel_residual: bool = False
    # variants of the llama graph the JAX package supports and this port
    # does not run yet; forward raises NotImplementedError when one is set
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    swa_window: int = 0
    swa_pattern: int = 0  # every Nth layer is full-attention (0 = no SWA)
    alibi_max_bias: float = 0.0
    kv_lora_rank: int = 0
    rope_sections: tuple | None = None
    nope_global_layers: bool = False  # cohere2: no rope on its global layers

    @property
    def n_rep(self) -> int:
        return self.n_heads // self.n_kv_heads

    def layer_is_swa(self, il: int) -> bool:
        """Whether layer il attends through the sliding window: with
        swa_pattern N, every layer but each Nth ((il + 1) % N != 0)."""
        if self.swa_window <= 0 or self.swa_pattern <= 0:
            return False
        return (il + 1) % self.swa_pattern != 0


def config_from_gguf(reader) -> ModelConfig:
    arch = reader.architecture
    if arch not in LLAMA_ARCHS:
        raise NotImplementedError(f"architecture {arch!r}: the port runs {LLAMA_ARCHS} only")
    ak = reader.akey
    n_embd = int(ak(Keys.LLM.EMBEDDING_LENGTH))
    n_heads = int(ak(Keys.Attention.HEAD_COUNT))
    n_kv = int(ak(Keys.Attention.HEAD_COUNT_KV, n_heads))
    head_dim = int(ak(Keys.Attention.KEY_LENGTH, n_embd // n_heads))
    vocab = ak(Keys.LLM.VOCAB_SIZE)
    if vocab is None:
        toks = reader.get(Keys.Tokenizer.LIST)
        vocab = len(toks) if toks is not None else 0
    ctx_len = int(ak(Keys.LLM.CONTEXT_LENGTH, 0))
    scaling_type = ak(Keys.Rope.SCALING_TYPE, "none") or "none"
    factor = float(ak(Keys.Rope.SCALING_FACTOR, 1.0) or 1.0)
    rope = RopeParams(
        n_dims=int(ak(Keys.Rope.DIMENSION_COUNT, head_dim)),
        mode=_ROPE_MODE[arch],
        freq_base=float(ak(Keys.Rope.FREQ_BASE, 10000.0)),
        freq_scale=1.0 / factor if scaling_type in ("linear", "yarn") and factor else 1.0,
        ext_factor=float(ak("{arch}.rope.scaling.extrapolation_factor", 1.0) or 1.0)
        if scaling_type == "yarn" else 0.0,
        attn_factor=float(ak(Keys.Rope.SCALING_ATTN_FACTOR, 1.0) or 1.0),
        beta_fast=float(ak(Keys.Rope.SCALING_BETA_FAST, 32.0) or 32.0),
        beta_slow=float(ak(Keys.Rope.SCALING_BETA_SLOW, 1.0) or 1.0),
        n_ctx_orig=int(ak(Keys.Rope.SCALING_ORIG_CTX, ctx_len) or ctx_len),
    )
    scale = ak(Keys.Attention.SCALE)
    cfg = ModelConfig(
        arch=arch,
        vocab_size=int(vocab),
        n_embd=n_embd,
        n_layers=int(ak(Keys.LLM.BLOCK_COUNT)),
        n_heads=n_heads,
        n_kv_heads=n_kv,
        head_dim=head_dim,
        head_dim_v=int(ak(Keys.Attention.VALUE_LENGTH, head_dim)),
        n_ff=int(ak(Keys.LLM.FEED_FORWARD_LENGTH, 0)),
        rms_eps=float(ak(Keys.Attention.LAYERNORM_RMS_EPS, 1e-5) or 1e-5),
        rope=rope,
        attn_scale=float(scale) if scale is not None else None,
        context_length=ctx_len,
        n_expert=int(ak(Keys.LLM.EXPERT_COUNT, 0) or 0),
        n_expert_used=int(ak(Keys.LLM.EXPERT_USED_COUNT, 0) or 0),
        n_ff_expert=int(ak(Keys.LLM.EXPERT_FEED_FORWARD_LENGTH, 0) or 0),
        swa_window=int(ak(Keys.Attention.SLIDING_WINDOW, 0) or 0),
    )
    # llm_tpu/models/config.py's per-arch adjustments, in its order
    if arch in ("qwen2", "qwen2moe"):
        cfg = replace(cfg, attn_bias=True)
    if cfg.n_expert > 0 and arch in ("llama", "mixtral", "qwen3moe"):
        # mixtral and qwen3moe normalize the top-k router weights (qwen2moe
        # does not: norm_topk_prob=false)
        cfg = replace(cfg, expert_weights_norm=True)
    if arch in ("qwen3", "qwen3moe"):
        cfg = replace(cfg, qk_norm=True)
    if arch == "gemma":
        cfg = replace(cfg, act="gelu", embedding_scale=float(n_embd) ** 0.5)
    if arch == "gemma2":
        # llm_tpu/models/config.py's gemma adjustments; 27B (46 layers)
        # scales by n_embd / n_head (llama-model.cpp), and a scale in the
        # file (the converter's query_pre_attn_scalar^-0.5) wins, as there
        n_layers = cfg.n_layers
        cfg = replace(
            cfg, act="gelu", embedding_scale=float(n_embd) ** 0.5,
            swa_window=int(ak(Keys.Attention.SLIDING_WINDOW, 4096) or 4096), swa_pattern=2,
            attn_softcap=float(ak("{arch}.attn_logit_softcapping", 50.0) or 50.0),
            final_softcap=float(ak("{arch}.final_logit_softcapping", 30.0) or 30.0),
            attn_scale=float(scale) if scale is not None else
            (n_embd / n_heads) ** -0.5 if n_layers == 46 else head_dim ** -0.5)
    if (arch == "baichuan" and cfg.n_layers == BAICHUAN_13B_LAYERS) or arch == "refact":
        # baichuan-13B and refact: no rope, ALiBi slopes of max_bias 8
        # (llm_tpu/models/config.py's baichuan and refact branches)
        cfg = alibi_profile(cfg)
    if arch == "granite":
        # granite's multipliers; the logits are divided by its logit scale
        cfg = replace(
            cfg, embedding_scale=float(ak("{arch}.embedding_scale", 1.0) or 1.0),
            residual_scale=float(ak("{arch}.residual_scale", 1.0) or 1.0),
            logit_scale=1.0 / float(ak("{arch}.logit_scale", 1.0) or 1.0),
            attn_scale=float(ak(Keys.Attention.SCALE, 0.0) or 0.0) or None)
    if arch == "minicpm":
        # minicpm runs granite's graph: the embedding times scale_emb, the
        # residuals times scale_depth / sqrt(n_layers) (1.4 / sqrt(n_layers)
        # where the file has none), the logits divided by its logit scale
        cfg = replace(
            cfg, embedding_scale=float(ak("{arch}.embedding_scale", 12.0) or 12.0),
            residual_scale=float(ak("{arch}.residual_scale", 0.0) or 0.0)
            or 1.4 / (cfg.n_layers ** 0.5),
            logit_scale=1.0 / (float(ak("{arch}.logit_scale", 0.0) or 0.0) or 1.0))
    if arch == "olmo2":
        # the post-norm block: no input norms (by its tensors), q and k
        # normed whole
        cfg = replace(cfg, qk_norm_full=True)
    if arch in ("bitnet", "arcee"):
        # BitNet b1.58: a gated squared relu (the sub-norms are tensors);
        # arcee: the same without a gate (no ffn_gate tensor)
        cfg = replace(cfg, act="relu2")
    # ernie4_5, xverse, internlm2, exaone: the llama graph; glm4 (post-norms,
    # QKV biases, packed gate+up) and phi3 (fused QKV, packed gate+up): by
    # their tensors
    if arch in LN_ARCHS:
        # llm_tpu/models/config.py's LayerNorm branches: gelu for most, an
        # ungated squared relu for nemotron; the parallel block for
        # command-r, falcon, phi2 and gptj, and for gptneox unless its file
        # says use_parallel_residual false; QKV biases for starcoder2,
        # stablelm and phi2; olmo's norms without parameters; no rope for
        # gpt2, starcoder, bloom and mpt, with ALiBi of max_bias 8 for bloom
        # and the file's max_alibi_bias for mpt; command-r's logit scale, a
        # multiplier (granite and minicpm divide by theirs)
        kw = dict(norm_kind="ln")
        if arch in ("falcon", "phi2", "gptneox", "gptj", "starcoder2", "gpt2", "starcoder",
                    "bloom", "mpt"):
            kw["act"] = "gelu"
        if arch == "nemotron":
            kw["act"] = "relu2"
        if arch in ("command-r", "falcon", "phi2", "gptj") or (
                arch == "gptneox" and bool(ak("{arch}.use_parallel_residual", True))):
            kw["parallel_residual"] = True
        if arch in ("starcoder2", "stablelm", "phi2"):
            kw["attn_bias"] = True
        if arch == "olmo":
            kw["nonparam_norm"] = True
        if arch in ("gpt2", "starcoder", "bloom", "mpt"):
            kw["rope"] = replace(rope, mode=ROPE_TYPE_NONE, n_dims=0)
        if arch == "bloom":
            kw["alibi_max_bias"] = ALIBI_MAX_BIAS
        if arch == "mpt":
            kw["alibi_max_bias"] = float(ak("{arch}.attention.max_alibi_bias", 8.0) or 8.0)
        if arch == "command-r":
            kw["logit_scale"] = float(ak("{arch}.logit_scale", 1.0) or 1.0)
        cfg = replace(cfg, **kw)
    return cfg


def alibi_profile(cfg: ModelConfig) -> ModelConfig:
    """cfg with rope NONE (n_dims 0) and ALiBi of max_bias 8: the profile
    of baichuan-13B and refact."""
    return replace(cfg, rope=replace(cfg.rope, mode=ROPE_TYPE_NONE, n_dims=0),
                   alibi_max_bias=ALIBI_MAX_BIAS)
