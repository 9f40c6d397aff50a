"""GGUF / ggml format constants: the port's own copy of
llm_tpu/gguf/constants.py (the port imports nothing of llm_tpu).

Format facts (enum numbering, block layouts, sizes) follow the public GGUF
v3 specification (ggml.h type enum, gguf.h value types, ggml-common.h block
layouts); they are part of the file format.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass

GGUF_MAGIC = b"GGUF"
GGUF_VERSION = 3
GGUF_DEFAULT_ALIGNMENT = 32

# Super-block size for K-quants (ggml-common.h:89-90).
QK_K = 256
K_SCALE_SIZE = 12


class GGUFValueType(enum.IntEnum):
    """Typed metadata value kinds in the GGUF KV section (gguf.h:54-67)."""

    UINT8 = 0
    INT8 = 1
    UINT16 = 2
    INT16 = 3
    UINT32 = 4
    INT32 = 5
    FLOAT32 = 6
    BOOL = 7
    STRING = 8
    ARRAY = 9
    UINT64 = 10
    INT64 = 11
    FLOAT64 = 12


class GGMLType(enum.IntEnum):
    """Tensor storage types (ggml.h:359-398). Gaps are removed legacy types."""

    F32 = 0
    F16 = 1
    Q4_0 = 2
    Q4_1 = 3
    Q5_0 = 6
    Q5_1 = 7
    Q8_0 = 8
    Q8_1 = 9
    Q2_K = 10
    Q3_K = 11
    Q4_K = 12
    Q5_K = 13
    Q6_K = 14
    Q8_K = 15
    IQ2_XXS = 16
    IQ2_XS = 17
    IQ3_XXS = 18
    IQ1_S = 19
    IQ4_NL = 20
    IQ3_S = 21
    IQ2_S = 22
    IQ4_XS = 23
    I8 = 24
    I16 = 25
    I32 = 26
    I64 = 27
    F64 = 28
    IQ1_M = 29
    BF16 = 30
    TQ1_0 = 34
    TQ2_0 = 35


@dataclass(frozen=True)
class TypeTraits:
    """Per-type block geometry: `block_size` values are stored in `type_size`
    bytes (ggml-common.h block structs)."""

    block_size: int  # number of f32 values per block
    type_size: int  # bytes per block on disk
    is_quantized: bool


# fmt: off
TYPE_TRAITS: dict[GGMLType, TypeTraits] = {
    GGMLType.F32:    TypeTraits(1,   4,   False),
    GGMLType.F16:    TypeTraits(1,   2,   False),
    GGMLType.BF16:   TypeTraits(1,   2,   False),
    GGMLType.F64:    TypeTraits(1,   8,   False),
    GGMLType.I8:     TypeTraits(1,   1,   False),
    GGMLType.I16:    TypeTraits(1,   2,   False),
    GGMLType.I32:    TypeTraits(1,   4,   False),
    GGMLType.I64:    TypeTraits(1,   8,   False),
    # legacy 32-value blocks (ggml-common.h:167-214)
    GGMLType.Q4_0:   TypeTraits(32,  2 + 16,          True),
    GGMLType.Q4_1:   TypeTraits(32,  2 + 2 + 16,      True),
    GGMLType.Q5_0:   TypeTraits(32,  2 + 4 + 16,      True),
    GGMLType.Q5_1:   TypeTraits(32,  2 + 2 + 4 + 16,  True),
    GGMLType.Q8_0:   TypeTraits(32,  2 + 32,          True),
    GGMLType.Q8_1:   TypeTraits(32,  2 + 2 + 32,      True),
    # K-quants: 256-value super-blocks (ggml-common.h:256-334)
    GGMLType.Q2_K:   TypeTraits(QK_K, 16 + QK_K // 4 + 2 + 2,            True),   # 84
    GGMLType.Q3_K:   TypeTraits(QK_K, QK_K // 8 + QK_K // 4 + 12 + 2,    True),   # 110
    GGMLType.Q4_K:   TypeTraits(QK_K, 2 + 2 + K_SCALE_SIZE + QK_K // 2,  True),   # 144
    GGMLType.Q5_K:   TypeTraits(QK_K, 2 + 2 + K_SCALE_SIZE + QK_K // 8 + QK_K // 2, True),  # 176
    GGMLType.Q6_K:   TypeTraits(QK_K, QK_K // 2 + QK_K // 4 + QK_K // 16 + 2, True),        # 210
    GGMLType.Q8_K:   TypeTraits(QK_K, 4 + QK_K + QK_K // 16 * 2,         True),   # 292
    # importance-grid / non-linear types (ggml-common.h:339-418)
    GGMLType.IQ4_NL: TypeTraits(32,   2 + 16,                  True),
    GGMLType.IQ4_XS: TypeTraits(QK_K, 2 + 2 + QK_K // 64 + QK_K // 2, True),      # 136
    GGMLType.IQ2_XXS: TypeTraits(QK_K, 2 + QK_K // 8 * 2,      True),
    GGMLType.IQ2_XS:  TypeTraits(QK_K, 2 + QK_K // 8 * 2 + QK_K // 32, True),
    GGMLType.IQ3_XXS: TypeTraits(QK_K, 2 + QK_K // 4 + QK_K // 8, True),
    GGMLType.IQ2_S:   TypeTraits(QK_K, 2 + QK_K // 4 + QK_K // 16, True),          # 82
    GGMLType.IQ3_S:   TypeTraits(QK_K, 2 + QK_K // 4 + QK_K // 32 + QK_K // 8 + QK_K // 64, True),  # 110
    GGMLType.IQ1_S:   TypeTraits(QK_K, 2 + QK_K // 8 + QK_K // 16, True),          # 50
    GGMLType.IQ1_M:   TypeTraits(QK_K, QK_K // 8 + QK_K // 16 + QK_K // 32, True), # 56
    GGMLType.TQ1_0:  TypeTraits(QK_K, 2 + 4 * 13,              True),
    GGMLType.TQ2_0:  TypeTraits(QK_K, 2 + QK_K // 4,           True),
}
# fmt: on


def type_traits(t: GGMLType | int) -> TypeTraits:
    t = GGMLType(t)
    if t not in TYPE_TRAITS:
        raise ValueError(f"unsupported ggml type {t!r}")
    return TYPE_TRAITS[t]


def row_nbytes(ggml_type: GGMLType | int, n_per_row: int) -> int:
    """Bytes for one row of `n_per_row` logical values."""
    tt = type_traits(ggml_type)
    if n_per_row % tt.block_size != 0:
        raise ValueError(
            f"row size {n_per_row} not a multiple of block size "
            f"{tt.block_size} for {GGMLType(ggml_type).name}"
        )
    return n_per_row // tt.block_size * tt.type_size


def tensor_nbytes(ggml_type: GGMLType | int, shape: tuple[int, ...]) -> int:
    """Total bytes for a tensor with logical shape `shape` (ne order:
    shape[0] = fastest-varying / row length, as in GGUF tensor info)."""
    if not shape:
        return type_traits(ggml_type).type_size
    n = 1
    for d in shape[1:]:
        n *= d
    return n * row_nbytes(ggml_type, shape[0])


class Keys:
    """The well-known metadata keys (part of the file format)."""

    class General:
        ARCHITECTURE = "general.architecture"
        NAME = "general.name"
        QUANTIZATION_VERSION = "general.quantization_version"
        ALIGNMENT = "general.alignment"
        FILE_TYPE = "general.file_type"

    class LLM:  # format with .format(arch=...)
        CONTEXT_LENGTH = "{arch}.context_length"
        EMBEDDING_LENGTH = "{arch}.embedding_length"
        BLOCK_COUNT = "{arch}.block_count"
        FEED_FORWARD_LENGTH = "{arch}.feed_forward_length"
        EXPERT_FEED_FORWARD_LENGTH = "{arch}.expert_feed_forward_length"
        USE_PARALLEL_RESIDUAL = "{arch}.use_parallel_residual"
        EXPERT_COUNT = "{arch}.expert_count"
        EXPERT_USED_COUNT = "{arch}.expert_used_count"
        EXPERT_SHARED_COUNT = "{arch}.expert_shared_count"
        EXPERT_WEIGHTS_SCALE = "{arch}.expert_weights_scale"
        EXPERT_WEIGHTS_NORM = "{arch}.expert_weights_norm"
        EXPERT_GATING_FUNC = "{arch}.expert_gating_func"
        VOCAB_SIZE = "{arch}.vocab_size"

    class SSM:  # state-space models (llama-arch.cpp:170-175)
        CONV_KERNEL = "{arch}.ssm.conv_kernel"
        INNER_SIZE = "{arch}.ssm.inner_size"
        STATE_SIZE = "{arch}.ssm.state_size"
        TIME_STEP_RANK = "{arch}.ssm.time_step_rank"
        GROUP_COUNT = "{arch}.ssm.group_count"
        DT_B_C_RMS = "{arch}.ssm.dt_b_c_rms"

    class Attention:
        HEAD_COUNT = "{arch}.attention.head_count"
        HEAD_COUNT_KV = "{arch}.attention.head_count_kv"
        LAYERNORM_RMS_EPS = "{arch}.attention.layer_norm_rms_epsilon"
        LAYERNORM_EPS = "{arch}.attention.layer_norm_epsilon"
        KEY_LENGTH = "{arch}.attention.key_length"
        VALUE_LENGTH = "{arch}.attention.value_length"
        SLIDING_WINDOW = "{arch}.attention.sliding_window"
        SCALE = "{arch}.attention.scale"

    class Rope:
        DIMENSION_COUNT = "{arch}.rope.dimension_count"
        FREQ_BASE = "{arch}.rope.freq_base"
        SCALING_TYPE = "{arch}.rope.scaling.type"
        SCALING_FACTOR = "{arch}.rope.scaling.factor"
        SCALING_ATTN_FACTOR = "{arch}.rope.scaling.attn_factor"
        SCALING_ORIG_CTX = "{arch}.rope.scaling.original_context_length"
        SCALING_FINETUNED = "{arch}.rope.scaling.finetuned"
        SCALING_YARN_LOG_MUL = "{arch}.rope.scaling.yarn_log_multiplier"
        SCALING_BETA_FAST = "{arch}.rope.scaling.beta_fast"
        SCALING_BETA_SLOW = "{arch}.rope.scaling.beta_slow"

    class Tokenizer:
        MODEL = "tokenizer.ggml.model"
        PRE = "tokenizer.ggml.pre"
        LIST = "tokenizer.ggml.tokens"
        TOKEN_TYPE = "tokenizer.ggml.token_type"
        SCORES = "tokenizer.ggml.scores"
        MERGES = "tokenizer.ggml.merges"
        BOS_ID = "tokenizer.ggml.bos_token_id"
        EOS_ID = "tokenizer.ggml.eos_token_id"
        EOT_ID = "tokenizer.ggml.eot_token_id"
        UNK_ID = "tokenizer.ggml.unknown_token_id"
        SEP_ID = "tokenizer.ggml.seperator_token_id"
        PAD_ID = "tokenizer.ggml.padding_token_id"
        ADD_BOS = "tokenizer.ggml.add_bos_token"
        ADD_EOS = "tokenizer.ggml.add_eos_token"
        ADD_SPACE_PREFIX = "tokenizer.ggml.add_space_prefix"
        REMOVE_EXTRA_WS = "tokenizer.ggml.remove_extra_whitespaces"
        PRECOMPILED_CHARSMAP = "tokenizer.ggml.precompiled_charsmap"
        FIM_PRE_ID = "tokenizer.ggml.fim_pre_token_id"
        FIM_SUF_ID = "tokenizer.ggml.fim_suf_token_id"
        FIM_MID_ID = "tokenizer.ggml.fim_mid_token_id"
        FIM_PAD_ID = "tokenizer.ggml.fim_pad_token_id"
        FIM_REP_ID = "tokenizer.ggml.fim_rep_token_id"
        FIM_SEP_ID = "tokenizer.ggml.fim_sep_token_id"
        # legacy FIM key names (pre-rename)
        PREFIX_ID = "tokenizer.ggml.prefix_token_id"
        SUFFIX_ID = "tokenizer.ggml.suffix_token_id"
        MIDDLE_ID = "tokenizer.ggml.middle_token_id"
        CHAT_TEMPLATE = "tokenizer.chat_template"


# llama_ftype-style file-level quant presets (llama.h): informational only.
class FileType(enum.IntEnum):
    ALL_F32 = 0
    MOSTLY_F16 = 1
    MOSTLY_Q4_0 = 2
    MOSTLY_Q4_1 = 3
    MOSTLY_Q8_0 = 7
    MOSTLY_Q5_0 = 8
    MOSTLY_Q5_1 = 9
    MOSTLY_Q2_K = 10
    MOSTLY_Q3_K_S = 11
    MOSTLY_Q3_K_M = 12
    MOSTLY_Q3_K_L = 13
    MOSTLY_Q4_K_S = 14
    MOSTLY_Q4_K_M = 15
    MOSTLY_Q5_K_S = 16
    MOSTLY_Q5_K_M = 17
    MOSTLY_Q6_K = 18
    MOSTLY_IQ2_XXS = 19
    MOSTLY_IQ4_NL = 25
    MOSTLY_IQ4_XS = 30
    MOSTLY_IQ1_M = 31
    MOSTLY_BF16 = 32
    MOSTLY_TQ1_0 = 36
    MOSTLY_TQ2_0 = 37
