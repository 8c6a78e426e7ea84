"""Config dataclasses of the port, with the JAX package's field names.

Port of ``rlinf_tpu/config.py``: ``TrainerConfig`` and its groups, YAML
loading with ``a.b=c`` overrides and the cross-field validators, so that one
YAML file drives both packages. ``LoRAConfig`` lives in
``models/llm/lora.py``, as in the JAX package. ``MeshConfig`` lives in
``parallel/mesh.py`` (re-exported here): the mesh block of a YAML is
validated here; the runners take a built mesh (``ReasoningRunner(mesh=)``),
and ``main_grpo`` builds none, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

from rlinf_tpu_torch.models.llm.config import LLMConfig
from rlinf_tpu_torch.models.llm.lora import LoRAConfig
from rlinf_tpu_torch.models.llm.sampler import SamplingParams
from rlinf_tpu_torch.parallel.mesh import MeshConfig
from rlinf_tpu_torch.training.learner import PolicyLossConfig
from rlinf_tpu_torch.training.train_state import OptimizerConfig


@dataclasses.dataclass(frozen=True)
class RolloutConfig:
    """Rollout/serving engine selection.

    engine:
      auto        static under a mesh, continuous otherwise
      static      one generate() per (P, N) bucket
      continuous  slot-pool continuous batching
      paged       continuous + paged KV pool
    weight_quant: "auto" = int8 weight-only decode on a CUDA device, none
    on the CPU.
    """

    engine: str = "auto"             # auto | static | continuous | paged
    weight_quant: str = "auto"       # auto | none | int8
    kv_quant: str = "none"           # none | int8 (continuous engine only)
    num_slots: int = 32              # continuous/paged slot-pool size
    decode_chunk: int = 16           # decode steps per host round
    prompt_bucket: int = 64
    page_size: int = 16              # paged engine only
    decode_attn_impl: Optional[str] = None   # None = pallas on CUDA, xla off


@dataclasses.dataclass(frozen=True)
class AlgorithmConfig:
    adv_type: str = "grpo"              # grpo | gae | reinpp | raw | opd | grpo_dynamic
    loss_type: str = "actor"            # registry name
    group_size: int = 8
    normalize_advantages: bool = True
    #: fp32 recompute of old_logprobs on the training path; None = whenever
    #: the rollout decode path differs from the training path
    recompute_logprobs: Optional[bool] = None
    critic: str = "shared"              # shared | separate (gae only)
    critic_warmup_steps: int = 0
    critic_lr: Optional[float] = None
    use_ref_logprobs: bool = False
    gamma: float = 1.0
    gae_lambda: float = 1.0


@dataclasses.dataclass(frozen=True)
class RunnerConfig:
    task_type: str = "reasoning"
    max_steps: int = 100
    seed: int = 0
    log_dir: Optional[str] = None
    checkpoint_dir: Optional[str] = None
    save_interval: int = 50
    resume: str = "auto"                # auto | none
    num_mini_batches: int = 1           # minibatches per rollout batch
    num_epochs: int = 1                 # PPO epochs over the rollout batch
    rollout_batch_size: int = 64        # prompts per step (pre group_size)


@dataclasses.dataclass(frozen=True)
class DataConfig:
    train_path: Optional[str] = None
    max_prompt_len: int = 512
    max_examples: Optional[int] = None
    type: str = "reasoning"          # reasoning | math | wideseek_r1 | rstar2
    train_data_paths: Optional[object] = None   # str or list[str]
    val_data_paths: Optional[object] = None
    prompt_key: str = "prompt"
    answer_key: str = "answer"
    apply_chat_template: bool = False
    filter_prompt_by_length: bool = False
    data_size: Optional[int] = None
    process_workers: int = 1
    process_batch_size: int = 256


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    model: LLMConfig = dataclasses.field(default_factory=LLMConfig.tiny)
    sampling: SamplingParams = dataclasses.field(default_factory=SamplingParams)
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    loss: PolicyLossConfig = dataclasses.field(default_factory=PolicyLossConfig)
    algorithm: AlgorithmConfig = dataclasses.field(default_factory=AlgorithmConfig)
    runner: RunnerConfig = dataclasses.field(default_factory=RunnerConfig)
    rollout: RolloutConfig = dataclasses.field(default_factory=RolloutConfig)
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    lora: LoRAConfig = dataclasses.field(default_factory=LoRAConfig)
    num_microbatches: int = 1
    #: True (or "full") recomputes each block in the backward, "dots" keeps
    #: the projections' outputs and recomputes the rest, False keeps all
    remat: object = True
    #: training attention: "auto" = the hand-written flash kernels on a CUDA
    #: device when the trained sequence length reaches ATTN_KERNELS_FROM_T
    #: (128, measured on the H100; the JAX package's threshold is 1024), the
    #: plain path otherwise; or force xla | pallas | ring
    attn_impl: str = "auto"


_SECTION_TYPES = {
    "model": LLMConfig,
    "sampling": SamplingParams,
    "optimizer": OptimizerConfig,
    "loss": PolicyLossConfig,
    "algorithm": AlgorithmConfig,
    "runner": RunnerConfig,
    "rollout": RolloutConfig,
    "data": DataConfig,
    "mesh": MeshConfig,
    "lora": LoRAConfig,
}


def _build_section(cls, data: Dict[str, Any]):
    fields = {f.name: f for f in dataclasses.fields(cls)}
    unknown = set(data) - set(fields)
    if unknown:
        raise ValueError(f"Unknown keys for {cls.__name__}: {sorted(unknown)}")
    coerced = {}
    for key, val in data.items():
        ftype = fields[key].type
        # PyYAML 1.1 parses "3e-4" as a string; coerce to declared numerics.
        if isinstance(val, str):
            if ftype in ("float", float, "Optional[float]"):
                try:
                    val = float(val)
                except ValueError:
                    pass
            elif ftype in ("int", int, "Optional[int]"):
                try:
                    val = int(val)
                except ValueError:
                    pass
        coerced[key] = val
    return cls(**coerced)


def config_from_dict(data: Dict[str, Any], validate: bool = True) -> TrainerConfig:
    kwargs: Dict[str, Any] = {}
    for key, val in data.items():
        if key in _SECTION_TYPES:
            kwargs[key] = _build_section(_SECTION_TYPES[key], val or {})
        else:
            kwargs[key] = val
    cfg = _build_section(TrainerConfig, kwargs)
    if validate:
        validate_config(cfg)
    return cfg


def config_to_dict(cfg: TrainerConfig) -> Dict[str, Any]:
    return dataclasses.asdict(cfg)


def load_config(path: Optional[str] = None, overrides: Optional[list] = None) -> TrainerConfig:
    """Load YAML + apply ``a.b=c`` overrides (values parsed as YAML scalars)."""
    import yaml

    data: Dict[str, Any] = {}
    if path:
        with open(path) as f:
            data = yaml.safe_load(f) or {}
    apply_overrides(data, overrides or [])
    return config_from_dict(data)


def apply_overrides(data: Dict[str, Any], overrides) -> None:
    """Set each ``a.b=c`` override (the value parsed as a YAML scalar) in
    the nested dict ``data``."""
    import yaml

    for ov in overrides:
        key, _, raw = ov.partition("=")
        node = data
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = yaml.safe_load(raw)


_TASK_TYPES = ("reasoning", "embodied", "sft", "offline", "agent", "serving")
_ADV_TYPES = ("grpo", "gae", "reinpp", "raw", "opd", "grpo_dynamic")
_DTYPES = ("bfloat16", "float32", "float16")


#: ``attn_impl="auto"`` takes the kernels (K1, K7, K8) from this trained
#: sequence length up: chip_smoke.py's attn_impl_threshold phase (forward
#: and backward of one Qwen2-1.5B layer on an H100) finds them faster than
#: the plain path at every T it times, the least of which is 128
ATTN_KERNELS_FROM_T = 128


def resolve_attn_impl(cfg: TrainerConfig, device="cuda") -> str:
    """Resolve ``attn_impl='auto'`` for the TRAINED sequence length (prompt
    + response, not the model's capacity): the kernels on a CUDA device
    from ATTN_KERNELS_FROM_T tokens, the plain path otherwise."""
    import torch

    if cfg.attn_impl != "auto":
        return cfg.attn_impl
    if torch.device(device).type != "cuda":
        return "xla"
    t = min(cfg.model.max_seq_len, cfg.data.max_prompt_len + cfg.sampling.max_new_tokens)
    if t < ATTN_KERNELS_FROM_T:
        return "xla"
    # the kernels, for a model they take: raise here rather than at the first batch
    from rlinf_tpu_torch.ops.cuda.geometry import check_kernel_geometry

    check_kernel_geometry(cfg.model, "flash")
    return "pallas"


def validate_config(cfg: TrainerConfig):
    """Cross-field checks, the JAX package's."""
    _validate_batching(cfg)
    _validate_model(cfg)
    _validate_mesh(cfg)
    _validate_rollout(cfg)
    task = cfg.runner.task_type
    if task not in _TASK_TYPES:
        raise ValueError(f"runner.task_type {task!r} unknown; expected one of {_TASK_TYPES}")
    if task == "reasoning":
        _validate_reasoning(cfg)


def _effective_group_size(cfg: TrainerConfig) -> int:
    if cfg.runner.task_type in ("reasoning", "agent"):
        return cfg.algorithm.group_size
    return 1


def _validate_batching(cfg: TrainerConfig):
    r = cfg.runner
    total = r.rollout_batch_size * _effective_group_size(cfg)
    if total % r.num_mini_batches != 0:
        raise ValueError(
            f"rollout_batch_size*group_size ({total}) must divide evenly into "
            f"num_mini_batches ({r.num_mini_batches})")
    mini = total // r.num_mini_batches
    if mini % cfg.num_microbatches != 0:
        raise ValueError(
            f"minibatch size ({mini}) not divisible by num_microbatches "
            f"({cfg.num_microbatches})")
    if r.save_interval < 1:
        raise ValueError("runner.save_interval must be >= 1")
    if r.resume not in ("auto", "none"):
        raise ValueError(f"runner.resume must be auto|none, got {r.resume!r}")


def _validate_model(cfg: TrainerConfig):
    m = cfg.model
    if m.dtype not in _DTYPES:
        raise ValueError(f"model.dtype {m.dtype!r} unsupported; use one of {_DTYPES}")
    if m.num_heads % m.num_kv_heads != 0:
        raise ValueError(
            f"model.num_heads ({m.num_heads}) must be a multiple of "
            f"num_kv_heads ({m.num_kv_heads}) for GQA")
    if m.is_moe:
        if m.num_experts_per_token > m.num_experts:
            raise ValueError(
                f"model.num_experts_per_token ({m.num_experts_per_token}) "
                f"exceeds num_experts ({m.num_experts})")
        if m.moe_impl not in ("capacity", "dropless"):
            raise ValueError(f"model.moe_impl {m.moe_impl!r} unknown; use capacity|dropless")
    s = cfg.sampling
    if s.max_new_tokens < 1:
        raise ValueError("sampling.max_new_tokens must be >= 1")
    if not (s.temperature > 0):
        raise ValueError(
            f"sampling.temperature must be > 0 (got {s.temperature}); "
            "use top_k=1 for greedy decoding")
    if s.max_new_tokens >= m.max_seq_len:
        raise ValueError(
            f"sampling.max_new_tokens ({s.max_new_tokens}) >= model.max_seq_len "
            f"({m.max_seq_len}) leaves no room for the prompt")


def _validate_mesh(cfg: TrainerConfig):
    me, m = cfg.mesh, cfg.model
    sizes = dataclasses.asdict(me)
    unknown = [k for k, v in sizes.items() if v == -1]
    if len(unknown) > 1:
        raise ValueError(f"mesh: at most one axis may be -1 (absorb), got {unknown}")
    for k, v in sizes.items():
        if v != -1 and v < 1:
            raise ValueError(f"mesh.{k} must be >= 1 or -1, got {v}")
    tp = me.tensor if me.tensor != -1 else 1
    if tp > 1:
        for name, val in (("num_heads", m.num_heads), ("num_kv_heads", m.num_kv_heads)):
            if val % tp != 0:
                raise ValueError(
                    f"model.{name} ({val}) not divisible by mesh.tensor ({tp})")
    cp = me.context if me.context != -1 else 1
    if cp > 1 and m.max_seq_len % cp != 0:
        raise ValueError(
            f"model.max_seq_len ({m.max_seq_len}) not divisible by mesh.context ({cp}) "
            "— ring attention shards the sequence evenly")
    ep = me.expert if me.expert != -1 else 1
    if ep > 1:
        if not m.is_moe:
            raise ValueError("mesh.expert > 1 but model has no experts; set mesh.expert=1")
        if m.num_experts % ep != 0:
            raise ValueError(
                f"model.num_experts ({m.num_experts}) not divisible by mesh.expert ({ep})")
    dp = me.data if me.data != -1 else 1
    fsdp = me.fsdp if me.fsdp != -1 else 1
    total = cfg.runner.rollout_batch_size * _effective_group_size(cfg)
    if (dp * fsdp) > 1 and total % (dp * fsdp) != 0:
        raise ValueError(
            f"global batch rollout_batch_size*group_size ({total}) not divisible by "
            f"mesh.data*mesh.fsdp ({dp * fsdp})")


def _validate_rollout(cfg: TrainerConfig):
    ro = cfg.rollout
    if ro.engine not in ("auto", "static", "continuous", "paged"):
        raise ValueError(f"unknown rollout.engine: {ro.engine!r}")
    if ro.weight_quant not in ("auto", "none", "int8"):
        raise ValueError(f"unknown rollout.weight_quant: {ro.weight_quant!r}")
    if ro.kv_quant not in ("none", "int8"):
        raise ValueError(f"unknown rollout.kv_quant: {ro.kv_quant!r}")
    if ro.engine == "paged" and ro.prompt_bucket % ro.page_size != 0:
        raise ValueError(
            f"rollout.prompt_bucket ({ro.prompt_bucket}) must be a multiple "
            f"of rollout.page_size ({ro.page_size})")
    if ro.num_slots < 1 or ro.decode_chunk < 1:
        raise ValueError("rollout.num_slots and rollout.decode_chunk must be >= 1")


def _validate_reasoning(cfg: TrainerConfig):
    a = cfg.algorithm
    if a.adv_type not in _ADV_TYPES:
        raise ValueError(f"algorithm.adv_type {a.adv_type!r} unknown; one of {_ADV_TYPES}")
    if a.critic not in ("shared", "separate"):
        raise ValueError(f"algorithm.critic must be shared|separate, got {a.critic!r}")
    if a.critic == "separate" and a.adv_type != "gae":
        raise ValueError("algorithm.critic='separate' requires adv_type='gae'")
    if a.adv_type in ("grpo", "grpo_dynamic") and a.group_size < 2:
        raise ValueError("GRPO needs group_size >= 2")
    if cfg.lora.enabled and a.adv_type == "gae":
        raise ValueError("lora.enabled with algorithm.adv_type=gae is unsupported")
