"""Train configs: the part that serving reads, and the one ``TrainConfig`` of the package.

Counterpart of ``kai0_tpu/training/config.py``: frozen-dataclass configs
(``AssetsConfig``, ``DataConfig``, the ``DataConfigFactory`` classes that
assemble the transform chain and load norm stats at run time), the per-model
``ModelTransformFactory`` (π₀, π₀.₅, their RTC variants and π₀-FAST),
``TrainConfig`` and ``get_config`` over the named configs (the ``debug*`` and
``*_base`` ones here, the robot ones in ``robot_configs.py``) with its
did-you-mean message.

``TrainConfig`` carries the fields serving reads (``name``, ``model``,
``data``, ``assets_base_dir``, ``exp_name``, ``policy_metadata``,
``assets_dirs``), those the train step reads (``train_lib.train_step``) and
those of the training loop (``train_lib.main``: seed, batch, workers, steps,
intervals, checkpoint directory and retention, resume, weight loader,
profiling), with JAX's defaults. A named config whose data path the port does
not have yet raises from ``get_config`` with the ROADMAP item that ports it.
"""

from __future__ import annotations

import abc
from collections.abc import Sequence
import dataclasses
import difflib
import logging
import pathlib
from typing import Any, Protocol

from kai0_tpu_torch import knobs as _knobs
from kai0_tpu_torch import transforms as _transforms
from kai0_tpu_torch.models import model as _model
from kai0_tpu_torch.models import pi0 as pi0_config
from kai0_tpu_torch.models import tokenizer as _tokenizer
from kai0_tpu_torch.shared import normalize as _normalize
from kai0_tpu_torch.training import optimizer as _optimizer
from kai0_tpu_torch.training import weight_loaders

logger = logging.getLogger("kai0_tpu_torch")

ModelType = _model.ModelType

@dataclasses.dataclass(frozen=True)
class AssetsConfig:
    """Location of assets (e.g. norm stats) used to set up the data pipeline.

    Assets are replicated inside the checkpoint under ``assets/<asset_id>``.
    """

    # If not provided, the config assets_dirs is used.
    assets_dir: str | None = None
    # If not provided, the repo id is used.
    asset_id: str | None = None


@dataclasses.dataclass(frozen=True)
class DataConfig:
    # LeRobot repo id. If None, fake data is created.
    repo_id: str | None = None
    # Directory within the assets directory containing the data assets.
    asset_id: str | None = None
    # Precomputed normalization stats. If None, normalization is skipped.
    norm_stats: dict[str, _normalize.NormStats] | None = None

    # dataset-format → common-format repack.
    repack_transforms: _transforms.Group = dataclasses.field(default_factory=_transforms.Group)
    # Robot-specific transforms, applied before normalization.
    data_transforms: _transforms.Group = dataclasses.field(default_factory=_transforms.Group)
    # Model-specific transforms, applied after normalization.
    model_transforms: _transforms.Group = dataclasses.field(default_factory=_transforms.Group)
    # Quantile vs z-score normalization.
    use_quantile_norm: bool = False

    # Keys used by the data loader to build the action sequence (length = action_horizon).
    action_sequence_keys: Sequence[str] = ("actions",)

    # If true, the LeRobot dataset task defines the prompt (AWBC conditioning).
    prompt_from_task: bool = False

    # Optional episode subset.
    episodes: Sequence[int] | None = None

    # Train-time space mirroring (data/augment_views.MirroredView): every frame plus its mirrored twin, the offline
    # create_mirror_and_merge without the second copy on disk; the arm blocks of the bimanual [L(7)][R(7)] layout.
    augment_mirror: bool = False
    augment_mirror_dims: tuple[int, int] = (7, 7)
    # Train-time time scaling (TimeScaledView: every Nth frame; 1 = off), the offline time_scale_dataset as a view.
    # The offline split mode stays augment/time_scaling.time_scaling_with_split.
    augment_time_scale: int = 1
    # The RLDS stream of the JAX package: the port's loader raises on it (ROADMAP Queue 1 item 4).
    rlds_data_dir: str | None = None


class GroupFactory(Protocol):
    def __call__(self, model_config) -> _transforms.Group: ...


@dataclasses.dataclass(frozen=True)
class ModelTransformFactory(GroupFactory):
    """The per-ModelType model transforms (``kai0_tpu/training/config.py:104-149``).

    π₀ tokenizes the prompt alone (its state is a token of the suffix); π₀.₅
    puts the discretized state in the prompt when ``discrete_state_input``;
    π₀-FAST tokenizes prompt, state and actions with ``FASTTokenizer`` and
    decodes the sampled tokens back into actions on the way out. FAST always
    gets ``FASTTokenizer(max_token_len)``: ``fast_model_tokenizer`` and its
    kwargs are not read, as in the JAX package (ROADMAP Queue 3).
    """

    default_prompt: str | None = None

    def __call__(self, model_config) -> _transforms.Group:
        mt = model_config.model_type
        if mt in (ModelType.PI0, ModelType.PI0_RTC):
            return _transforms.Group(
                inputs=[
                    _transforms.InjectDefaultPrompt(self.default_prompt),
                    _transforms.ResizeImages(224, 224),
                    _transforms.TokenizePrompt(_tokenizer.PaligemmaTokenizer(model_config.max_token_len)),
                    _transforms.PadStatesAndActions(model_config.action_dim),
                ],
            )
        if mt == ModelType.PI0_FAST:
            tokenizer = _tokenizer.FASTTokenizer(model_config.max_token_len)
            return _transforms.Group(
                inputs=[
                    _transforms.InjectDefaultPrompt(self.default_prompt),
                    _transforms.ResizeImages(224, 224),
                    _transforms.TokenizeFASTInputs(tokenizer),
                ],
                outputs=[
                    _transforms.ExtractFASTActions(
                        tokenizer, action_horizon=model_config.action_horizon, action_dim=model_config.action_dim
                    )
                ],
            )
        if mt in (ModelType.PI05, ModelType.PI05_RTC):
            return _transforms.Group(
                inputs=[
                    _transforms.InjectDefaultPrompt(self.default_prompt),
                    _transforms.ResizeImages(224, 224),
                    _transforms.TokenizePrompt(
                        _tokenizer.PaligemmaTokenizer(model_config.max_token_len),
                        discrete_state_input=model_config.discrete_state_input,
                    ),
                    _transforms.PadStatesAndActions(model_config.action_dim),
                ],
            )
        raise ValueError(f"Unsupported model type {mt}")


@dataclasses.dataclass(frozen=True)
class DataConfigFactory(abc.ABC):
    repo_id: str = "MISSING"
    assets: AssetsConfig = dataclasses.field(default_factory=AssetsConfig)
    base_config: DataConfig | None = None

    @abc.abstractmethod
    def create(self, assets_dirs: pathlib.Path, model_config) -> DataConfig: ...

    def create_base_config(self, assets_dirs: pathlib.Path, model_config) -> DataConfig:
        repo_id = self.repo_id if self.repo_id != "MISSING" else None
        asset_id = self.assets.asset_id or repo_id
        return dataclasses.replace(
            self.base_config or DataConfig(),
            repo_id=repo_id,
            asset_id=asset_id,
            norm_stats=self._load_norm_stats(pathlib.Path(self.assets.assets_dir or assets_dirs), asset_id),
            use_quantile_norm=model_config.model_type not in (ModelType.PI0, ModelType.PI0_RTC),
        )

    def _load_norm_stats(self, assets_dir: pathlib.Path, asset_id: str | None):
        """Norm stats from a local directory (the port downloads nothing), or None."""
        if asset_id is None:
            return None
        data_assets_dir = assets_dir / asset_id
        try:
            norm_stats = _normalize.load(data_assets_dir)
            logger.info(f"Loaded norm stats from {data_assets_dir}")
            return norm_stats
        except FileNotFoundError:
            logger.info(f"Norm stats not found in {data_assets_dir}, skipping.")
        return None


@dataclasses.dataclass(frozen=True)
class FakeDataConfig(DataConfigFactory):
    repo_id: str = "fake"

    def create(self, assets_dirs: pathlib.Path, model_config) -> DataConfig:
        return dataclasses.replace(self.base_config or DataConfig(), repo_id=self.repo_id)


@dataclasses.dataclass(frozen=True)
class SimpleDataConfig(DataConfigFactory):
    """Data transforms from a factory of the model config, and the model's own transforms (``config.py:194-205``)."""

    data_transforms: GroupFactory = dataclasses.field(default_factory=lambda: (lambda mc: _transforms.Group()))
    model_transforms: GroupFactory = dataclasses.field(default_factory=ModelTransformFactory)

    def create(self, assets_dirs: pathlib.Path, model_config) -> DataConfig:
        return dataclasses.replace(
            self.create_base_config(assets_dirs, model_config),
            data_transforms=self.data_transforms(model_config),
            model_transforms=self.model_transforms(model_config),
        )


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    # Unique config name used to reference this config from the CLI.
    name: str = "MISSING"
    # Experiment name; names the metadata and checkpoint directories.
    exp_name: str = "MISSING"

    model: Any = dataclasses.field(default_factory=pi0_config.Pi0Config)
    data: DataConfigFactory = dataclasses.field(default_factory=FakeDataConfig)
    assets_base_dir: str = "./assets"
    # Metadata passed to the policy server.
    policy_metadata: dict[str, Any] | None = None

    # Optionally loads (possibly partial) weights after model init.
    weight_loader: weight_loaders.WeightLoader = dataclasses.field(default_factory=weight_loaders.NoOpWeightLoader)

    # What the train step reads (train_lib.train_step).
    optimizer: _optimizer.AdamW = dataclasses.field(default_factory=_optimizer.AdamW)
    lr_schedule: _optimizer.CosineDecaySchedule | _optimizer.RsqrtDecaySchedule = dataclasses.field(
        default_factory=_optimizer.CosineDecaySchedule
    )
    ema_decay: float | None = 0.99
    param_dtype: str | None = None  # storage dtype of the trainable parameters; None keeps the model's (f32)
    quantize_frozen: bool = False  # int8 frozen base: quantized once at init, never updated (ops/quant.py)
    # The int8 modes (kai0_tpu_torch/knobs.py; ``--knobs.int8_sb_gemma=ffn``); the KAI0_INT8_* environment wins.
    knobs: _knobs.Knobs = dataclasses.field(default_factory=_knobs.Knobs)

    # What the training loop reads (train_lib.main).
    checkpoint_base_dir: str = "./checkpoints"
    seed: int = 42
    batch_size: int = 32  # on the one card
    num_workers: int = 2  # spawn processes that read items; 0 reads them in one thread
    num_train_steps: int = 30_000
    log_interval: int = 100
    save_interval: int = 1000
    # Existing checkpoints with step % keep_period == 0 are retained.
    keep_period: int | None = 5000
    overwrite: bool = False
    resume: bool = False
    # Metrics logging (metrics.jsonl always; wandb when it imports and this is on).
    wandb_enabled: bool = True
    advantage_estimator: bool = False  # the loader pairs each frame with a comparison frame (AdvantageLerobotDataset)
    split: str = "all"  # one of ['train', 'val', 'all']
    drop_last: bool = True
    skip_norm_stats: bool = False
    # torch.profiler trace: from `profile_start_step`, `profile_steps` steps to <checkpoint_dir>/profile; 0 disables.
    profile_start_step: int = 0
    profile_steps: int = 0
    # Sharding over several cards waits for ROADMAP Queue 1 item 10; train_lib.main raises on > 1.
    fsdp_devices: int = 1

    @property
    def assets_dirs(self) -> pathlib.Path:
        return (pathlib.Path(self.assets_base_dir) / self.name).resolve()

    @property
    def checkpoint_dir(self) -> pathlib.Path:
        if not self.exp_name or self.exp_name == "MISSING":
            raise ValueError("--exp_name must be set")
        return (pathlib.Path(self.checkpoint_base_dir) / self.name / self.exp_name).resolve()

    def __post_init__(self) -> None:
        if self.resume and self.overwrite:
            raise ValueError("Cannot resume and overwrite at the same time.")


def _agilex_transforms(model_config) -> _transforms.Group:
    from kai0_tpu_torch.policies import agilex_policy

    return _transforms.Group(
        inputs=[agilex_policy.AgilexInputs(action_dim=model_config.action_dim, model_type=model_config.model_type)],
        outputs=[agilex_policy.AgilexOutputs()],
    )


def _configs() -> list[TrainConfig]:
    from kai0_tpu_torch.training import robot_configs

    # JAX's debug model is π₀ at dummy size; debug_pi05 replaces it to pi05=True, keeping π₀'s 48 prompt tokens
    # and continuous state.
    debug_model = pi0_config.Pi0Config(
        paligemma_variant="dummy", action_expert_variant="dummy", vision_variant="mu/14", dtype="float32"
    )
    debug_pi05 = dataclasses.replace(debug_model, pi05=True)
    # The debug loop of the JAX configs: 4 steps of batch 2, a save at steps 2 and 3, a log every step.
    debug_loop = dict(batch_size=2, num_train_steps=4, save_interval=2, keep_period=2, log_interval=1, num_workers=0,
                      wandb_enabled=False)
    return [
        TrainConfig(name="debug", model=debug_model, data=FakeDataConfig(), ema_decay=None, **debug_loop),
        # Restores the `debug` run's last checkpoint (step 3) through the weight loader; the port's checkpoints are
        # <step>/model.safetensors where JAX's are <step>/params.
        TrainConfig(
            name="debug_restore",
            model=debug_model,
            data=FakeDataConfig(),
            ema_decay=None,
            weight_loader=weight_loaders.CheckpointWeightLoader("./checkpoints/debug/debug/3/model.safetensors"),
            **debug_loop,
        ),
        TrainConfig(name="debug_pi05", model=debug_pi05, data=FakeDataConfig(), **debug_loop),
        TrainConfig(
            name="debug_lora",
            model=dataclasses.replace(
                debug_pi05, paligemma_variant="dummy_lora", action_expert_variant="dummy_lora", dtype="bfloat16"
            ),
            data=FakeDataConfig(),
            ema_decay=None,
            **debug_loop,
        ),
        # Serving smoke config: the debug model behind the Agilex robot transforms (tokenize/resize/pad).
        TrainConfig(
            name="debug_serve",
            model=debug_model,
            data=SimpleDataConfig(repo_id="fake", data_transforms=_agilex_transforms),
            ema_decay=None,
            **{**debug_loop, "keep_period": 5000},
        ),
        TrainConfig(name="pi0_base", model=pi0_config.Pi0Config(), data=FakeDataConfig()),
        TrainConfig(name="pi05_base", model=pi0_config.Pi0Config(pi05=True), data=FakeDataConfig()),
        *robot_configs.configs(),
    ]


_CONFIGS_CACHE: dict[str, TrainConfig] | None = None


def registry() -> dict[str, TrainConfig]:
    global _CONFIGS_CACHE
    if _CONFIGS_CACHE is None:
        configs = _configs()
        if len({c.name for c in configs}) != len(configs):
            raise ValueError("Config names must be unique.")
        _CONFIGS_CACHE = {c.name: c for c in configs}
    return _CONFIGS_CACHE


def get_config(config_name: str) -> TrainConfig:
    """A named config; a name the port does not serve yet raises with its ROADMAP item, an unknown one with
    did-you-mean suggestions."""
    from kai0_tpu_torch.training import robot_configs

    configs = registry()
    if config_name in configs:
        return configs[config_name]
    if config_name in robot_configs.PENDING:
        raise NotImplementedError(
            f"Config {config_name!r} needs {robot_configs.PENDING[config_name]}, which the port does not have yet; "
            "the JAX package (kai0_tpu.training.config) serves it"
        )
    closest = difflib.get_close_matches(config_name, [*configs, *robot_configs.PENDING], n=5, cutoff=0.0)
    raise ValueError(f"Config {config_name!r} not found. Did you mean one of: {closest}?")


def cli(argv: list[str] | None = None) -> TrainConfig:
    """The config named by ``argv`` (``sys.argv[1:]`` by default) with its ``--a.b=value`` overrides."""
    from kai0_tpu_torch.training import cli as _cli

    return _cli.cli(registry(), argv)
