"""Per-robot data config factories and the named configs the port serves.

Counterpart of ``kai0_tpu/training/robot_configs.py`` and of the RoboArena
and PolaRiS packs (``kai0_tpu/training/misc/{roboarena,polaris}_config.py``):
the LeRobot data factories of Aloha, Libero, Agilex, ARX and DROID and the
DROID RLDS factory (each builds the repack, robot and model transform groups
and reads the norm stats), and every named π₀, π₀.₅ and π₀-FAST config, among
them the six kai0 task configs
(``pi05_{flatten_fold,tee_shirt_sort,hang_cloth}_{normal,awbc}``) and the
RTC serving config ``pi05_rtc_flatten_fold_inference`` and the two Stage
Advantage estimators ``ADVANTAGE_TORCH_{KAI0,PI06}_FLATTEN_FOLD``, with the training
fields of the JAX configs (weight loaders, step counts, batch sizes, workers,
retention). A weight loader reads a local ``model.safetensors``; the JAX
configs' ``gs://`` checkpoints raise when loaded (the port downloads nothing).
A config on ``RLDSDroidDataConfig`` serves, and its training raises in the
loader: the ``tf.data`` stream is ROADMAP Queue 1 item 4.

``PENDING`` names every config of the JAX registry that the port does not
have yet, with what it needs; ``config.get_config`` raises on those names.
"""

from __future__ import annotations

from collections.abc import Sequence
import dataclasses
import enum
import pathlib

from kai0_tpu_torch import transforms as _transforms
from kai0_tpu_torch.models import advantage as _advantage_model
from kai0_tpu_torch.models import model as _model
from kai0_tpu_torch.models import pi0 as pi0_config
from kai0_tpu_torch.models import pi0_fast as pi0_fast_config
from kai0_tpu_torch.models import pi0_rtc as pi0_rtc_config
from kai0_tpu_torch.models import tokenizer as _tokenizer
from kai0_tpu_torch.policies import agilex_policy, aloha_policy, arx_policy, droid_policy, libero_policy
from kai0_tpu_torch.training import config as _config
from kai0_tpu_torch.training import optimizer as _optimizer
from kai0_tpu_torch.training import weight_loaders

_RLDS = "the RLDS data loader (ROADMAP Queue 1 item 4)"
PENDING = dict.fromkeys(("pi05_full_droid_finetune", "pi05_droid_jointpos_polaris"), _RLDS)


def _model_transforms(model_config, default_prompt=None):
    return _config.ModelTransformFactory(default_prompt=default_prompt)(model_config)


# --------------------------------------------------------------------------------------
# Data config factories
# --------------------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LeRobotAlohaDataConfig(_config.DataConfigFactory):
    """Aloha datasets (reference config.py:231-281)."""

    use_delta_joint_actions: bool = True
    default_prompt: str | None = None
    adapt_to_pi: bool = True
    repack_transforms: _transforms.Group = dataclasses.field(
        default_factory=lambda: _transforms.Group(
            inputs=[
                _transforms.RepackTransform(
                    {
                        "images": {"cam_high": "observation.images.top"},
                        "state": "observation.state",
                        "actions": "action",
                    }
                )
            ]
        )
    )
    action_sequence_keys: Sequence[str] = ("action",)

    def create(self, assets_dirs: pathlib.Path, model_config) -> _config.DataConfig:
        data_transforms = _transforms.Group(
            inputs=[aloha_policy.AlohaInputs(adapt_to_pi=self.adapt_to_pi)],
            outputs=[aloha_policy.AlohaOutputs(adapt_to_pi=self.adapt_to_pi)],
        )
        if self.use_delta_joint_actions:
            delta_action_mask = _transforms.make_bool_mask(6, -1, 6, -1)
            data_transforms = data_transforms.push(
                inputs=[_transforms.DeltaActions(delta_action_mask)],
                outputs=[_transforms.AbsoluteActions(delta_action_mask)],
            )
        return dataclasses.replace(
            self.create_base_config(assets_dirs, model_config),
            repack_transforms=self.repack_transforms,
            data_transforms=data_transforms,
            model_transforms=_model_transforms(model_config, self.default_prompt),
            action_sequence_keys=tuple(self.action_sequence_keys),
        )


@dataclasses.dataclass(frozen=True)
class LeRobotLiberoDataConfig(_config.DataConfigFactory):
    """Libero datasets (reference config.py:284-358)."""

    extra_delta_transform: bool = False

    def create(self, assets_dirs: pathlib.Path, model_config) -> _config.DataConfig:
        repack_transforms = _transforms.Group(
            inputs=[
                _transforms.RepackTransform(
                    {
                        "observation/image": "image",
                        "observation/wrist_image": "wrist_image",
                        "observation/state": "state",
                        "actions": "actions",
                        "prompt": "prompt",
                    }
                )
            ]
        )
        data_transforms = _transforms.Group(
            inputs=[libero_policy.LiberoInputs(model_type=model_config.model_type)],
            outputs=[libero_policy.LiberoOutputs()],
        )
        if self.extra_delta_transform:
            delta_action_mask = _transforms.make_bool_mask(6, -1)
            data_transforms = data_transforms.push(
                inputs=[_transforms.DeltaActions(delta_action_mask)],
                outputs=[_transforms.AbsoluteActions(delta_action_mask)],
            )
        return dataclasses.replace(
            self.create_base_config(assets_dirs, model_config),
            repack_transforms=repack_transforms,
            data_transforms=data_transforms,
            model_transforms=_model_transforms(model_config),
        )


def _bimanual_repack(cameras: dict[str, str], *, history: bool = False, extra: dict | None = None):
    images = dict(cameras)
    if history:
        images.update({f"his_-100_{k}": f"his_-100_{v}" for k, v in cameras.items()})
    structure = {
        "images": images,
        "state": "observation.state",
        "actions": "action",
    }
    structure.update(extra or {})
    return _transforms.Group(inputs=[_transforms.RepackTransform(structure)])


_AGILEX_CAMERAS = {
    "top_head": "observation.images.top_head",
    "hand_left": "observation.images.hand_left",
    "hand_right": "observation.images.hand_right",
}


@dataclasses.dataclass(frozen=True)
class LerobotAgilexDataConfig(_config.DataConfigFactory):
    """Agilex dual-arm datasets — the kai0 task robot (reference config.py:360-453)."""

    use_delta_joint_actions: bool = True
    default_prompt: str | None = None
    episodes: Sequence[int] | None = None
    repack_transforms: _transforms.Group | None = None
    action_sequence_keys: Sequence[str] = ("action",)
    mask_state: bool = False
    insert_advantage_into_prompt: bool = False
    # Advantage-estimator training: include history cameras + progress columns.
    advantage_fields: bool = False

    _inputs_cls = agilex_policy.AgilexInputs
    _outputs_cls = agilex_policy.AgilexOutputs

    def create(self, assets_dirs: pathlib.Path, model_config) -> _config.DataConfig:
        default_prompt = self.default_prompt
        repack_transforms = self.repack_transforms
        if repack_transforms is None:
            extra = None
            if self.advantage_fields:
                extra = {
                    "episode_length": "episode_length",
                    "frame_index": "frame_index",
                    "episode_index": "episode_index",
                    "stage_progress_gt": "stage_progress_gt",
                    "progress": "progress",
                }
            repack_transforms = _bimanual_repack(_AGILEX_CAMERAS, history=self.advantage_fields, extra=extra)

        if self.base_config and self.base_config.prompt_from_task:
            # AWBC: the per-frame task string (with advantage suffix) is the prompt.
            default_prompt = None
            repack = repack_transforms.inputs[0]
            structure = dict(repack.structure)
            structure["prompt"] = "prompt"
            repack_transforms = _transforms.Group(inputs=[_transforms.RepackTransform(structure)])

        data_transforms = _transforms.Group(
            inputs=[
                self._inputs_cls(
                    action_dim=model_config.action_dim,
                    model_type=model_config.model_type,
                    mask_state=self.mask_state,
                )
            ],
            outputs=[self._outputs_cls()],
        )
        if self.insert_advantage_into_prompt:
            data_transforms = _transforms.Group(
                inputs=[_transforms.InsertAdvantageIntoPrompt(), *data_transforms.inputs],
                outputs=data_transforms.outputs,
            )
        if self.use_delta_joint_actions:
            # Dual-arm layout: joints 0-5 + gripper 6, joints 7-12 + gripper 13.
            delta_action_mask = _transforms.make_bool_mask(6, -1, 6, -1)
            data_transforms = data_transforms.push(
                inputs=[_transforms.DeltaActions(delta_action_mask)],
                outputs=[_transforms.AbsoluteActions(delta_action_mask)],
            )

        return dataclasses.replace(
            self.create_base_config(assets_dirs, model_config),
            repack_transforms=repack_transforms,
            data_transforms=data_transforms,
            model_transforms=_model_transforms(model_config, default_prompt),
            action_sequence_keys=tuple(self.action_sequence_keys),
            episodes=tuple(self.episodes) if self.episodes is not None else None,
        )


@dataclasses.dataclass(frozen=True)
class LerobotARXDataConfig(LerobotAgilexDataConfig):
    """ARX dual-arm datasets — same pipeline, no [−π, π] clipping (config.py:455-547)."""

    _inputs_cls = arx_policy.ARXInputs
    _outputs_cls = arx_policy.ARXOutputs


@dataclasses.dataclass(frozen=True)
class LeRobotDROIDDataConfig(_config.DataConfigFactory):
    """DROID LeRobot datasets (reference config.py:617-653)."""

    default_prompt: str | None = None

    def create(self, assets_dirs: pathlib.Path, model_config) -> _config.DataConfig:
        repack_transforms = _transforms.Group(
            inputs=[
                _transforms.RepackTransform(
                    {
                        "observation/exterior_image_1_left": "observation.images.exterior_image_1_left",
                        "observation/wrist_image_left": "observation.images.wrist_image_left",
                        "observation/joint_position": "observation.joint_position",
                        "observation/gripper_position": "observation.gripper_position",
                        "actions": "action",
                        "prompt": "prompt",
                    }
                )
            ]
        )
        data_transforms = _transforms.Group(
            inputs=[droid_policy.DroidInputs(model_type=model_config.model_type)],
            outputs=[droid_policy.DroidOutputs()],
        )
        return dataclasses.replace(
            self.create_base_config(assets_dirs, model_config),
            repack_transforms=repack_transforms,
            data_transforms=data_transforms,
            model_transforms=_model_transforms(model_config, self.default_prompt),
            action_sequence_keys=("action",),
        )


class DroidActionSpace(enum.Enum):
    """The action space of the DROID RLDS stream (``kai0_tpu/training/droid_rlds_dataset.py:29-31``)."""

    JOINT_POSITION = enum.auto()
    JOINT_VELOCITY = enum.auto()


@dataclasses.dataclass(frozen=True)
class RLDSDataset:
    """One RLDS dataset of a weighted mix (``droid_rlds_dataset.py:34-39``)."""

    name: str
    version: str
    weight: float
    filter_dict_path: str | None = None


@dataclasses.dataclass(frozen=True)
class RLDSDroidDataConfig(_config.DataConfigFactory):
    """DROID through the ``tf.data`` RLDS stream (``kai0_tpu/training/robot_configs.py:258-309``).

    The transforms are the JAX factory's (joint-position actions train on
    deltas, the gripper absolute), so a config on it serves; the stream itself
    is not ported and ``data_loader.create_data_loader`` raises on
    ``rlds_data_dir``.
    """

    rlds_data_dir: str | None = None
    action_space: DroidActionSpace | None = None
    datasets: tuple = ()  # the weighted mix the stream reads (DROID alone when empty)

    def create(self, assets_dirs: pathlib.Path, model_config) -> _config.DataConfig:
        if self.rlds_data_dir is None:
            raise ValueError("Need to set rlds_data_dir for the RLDS data loader.")
        action_space = self.action_space or DroidActionSpace.JOINT_POSITION
        repack_transforms = _transforms.Group(
            inputs=[
                _transforms.RepackTransform(
                    {
                        "observation/exterior_image_1_left": "observation/image",
                        "observation/wrist_image_left": "observation/wrist_image",
                        "observation/joint_position": "observation/joint_position",
                        "observation/gripper_position": "observation/gripper_position",
                        "actions": "actions",
                        "prompt": "prompt",
                    }
                )
            ]
        )
        data_transforms = _transforms.Group(
            inputs=[droid_policy.DroidInputs(model_type=model_config.model_type)],
            outputs=[droid_policy.DroidOutputs()],
        )
        if action_space == DroidActionSpace.JOINT_POSITION:
            # The stream yields absolute joint positions: train on deltas (the gripper stays absolute).
            delta_action_mask = _transforms.make_bool_mask(7, -1)
            data_transforms = data_transforms.push(
                inputs=[_transforms.DeltaActions(delta_action_mask)],
                outputs=[_transforms.AbsoluteActions(delta_action_mask)],
            )
        return dataclasses.replace(
            self.create_base_config(assets_dirs, model_config),
            repack_transforms=repack_transforms,
            data_transforms=data_transforms,
            model_transforms=_model_transforms(model_config, None),
            rlds_data_dir=self.rlds_data_dir,
        )


# --------------------------------------------------------------------------------------
# Named configs
# --------------------------------------------------------------------------------------

_KAI0_TASKS = {
    "flatten_fold": ("FlattenFold", "Flatten and fold the cloth.", LerobotAgilexDataConfig),
    "tee_shirt_sort": (
        "TeeShirtSort",
        "Fetch the clothes, fold the tee shirts and hand-over the collared shirts.",
        LerobotAgilexDataConfig,
    ),
    "hang_cloth": ("HangCloth", "Fetch and hang the cloth.", LerobotARXDataConfig),
}


# The base checkpoint of the kai0 fine-tunes: a local π₀.₅ in the PI0Pytorch layout (JAX: the Orbax ``params``).
_PI05_BASE_CKPT = "<path/to/pi05_base/checkpoint>/model.safetensors"
_PI05_GS = "gs://openpi-assets/checkpoints/pi05_base/params"
# The loop of the kai0 task configs (kai0_tpu/training/robot_configs.py:342-346).
_KAI0_LOOP = dict(num_train_steps=100_000, keep_period=5000, num_workers=8, batch_size=256)


def _kai0_finetune(name: str, task: str, *, awbc: bool = False) -> _config.TrainConfig:
    dataset_dir, prompt, data_cls = _KAI0_TASKS[task]
    variant = "advantage" if awbc else "base"
    return _config.TrainConfig(
        name=name,
        model=pi0_config.Pi0Config(pi05=True),
        data=data_cls(
            repo_id=f"data/{dataset_dir}/{variant}",
            default_prompt=prompt,
            use_delta_joint_actions=False,
            base_config=_config.DataConfig(prompt_from_task=True) if awbc else None,
        ),
        weight_loader=weight_loaders.CheckpointWeightLoader(_PI05_BASE_CKPT),
        **_KAI0_LOOP,
    )


def _kai0_advantage(name: str, task: str) -> _config.TrainConfig:
    """The Stage Advantage estimator of a kai0 task (``kai0_tpu/training/robot_configs.py:350-375``): π₀.₅ with a
    value head, trained on the value loss alone over the annotated dataset's train split."""
    dataset_dir, prompt, data_cls = _KAI0_TASKS[task]
    return _config.TrainConfig(
        name=name,
        advantage_estimator=True,
        model=_advantage_model.AdvantageEstimatorConfig(
            pi05=True, loss_value_weight=1.0, loss_action_weight=0.0, discrete_state_input=False
        ),
        data=data_cls(
            repo_id=f"data/{dataset_dir}/annotated",
            default_prompt=prompt,
            use_delta_joint_actions=False,
            advantage_fields=True,
        ),
        weight_loader=weight_loaders.CheckpointWeightLoader(_PI05_BASE_CKPT),
        num_train_steps=30_000,
        keep_period=5000,
        num_workers=8,
        batch_size=32,
        split="train",
    )


_PI0_GS = "gs://openpi-assets/checkpoints/pi0_base/params"
_PI0_FAST_GS = "gs://openpi-assets/checkpoints/pi0_fast_base/params"
_PI0_GS_ASSETS = "gs://openpi-assets/checkpoints/pi0_base/assets"


def _pi0_configs() -> list[_config.TrainConfig]:
    """The π₀ and π₀-FAST configs of ``kai0_tpu/training/robot_configs.py:382-575``."""
    TrainConfig = _config.TrainConfig
    trossen = _config.AssetsConfig(asset_id="trossen")
    libero = dict(repo_id="physical-intelligence/libero")
    return [
        TrainConfig(
            name="pi0_aloha",
            model=pi0_config.Pi0Config(),
            data=LeRobotAlohaDataConfig(assets=trossen),
            weight_loader=weight_loaders.CheckpointWeightLoader(_PI0_GS),
        ),
        TrainConfig(
            name="pi0_aloha_towel",
            model=pi0_config.Pi0Config(),
            data=LeRobotAlohaDataConfig(default_prompt="fold the towel", assets=trossen),
            weight_loader=weight_loaders.CheckpointWeightLoader(_PI0_GS),
        ),
        TrainConfig(
            name="pi0_aloha_tupperware",
            model=pi0_config.Pi0Config(),
            data=LeRobotAlohaDataConfig(default_prompt="open the tupperware and put the food on the plate",
                                        assets=trossen),
            weight_loader=weight_loaders.CheckpointWeightLoader(_PI0_GS),
        ),
        TrainConfig(
            name="pi0_aloha_pen_uncap",
            model=pi0_config.Pi0Config(),
            data=LeRobotAlohaDataConfig(
                repo_id="physical-intelligence/aloha_pen_uncap_diverse",
                default_prompt="uncap the pen",
                assets=_config.AssetsConfig(assets_dir=_PI0_GS_ASSETS, asset_id="trossen"),
            ),
            weight_loader=weight_loaders.CheckpointWeightLoader(_PI0_GS),
            num_train_steps=20_000,
        ),
        TrainConfig(
            name="pi0_aloha_sim",
            model=pi0_config.Pi0Config(),
            data=LeRobotAlohaDataConfig(
                repo_id="lerobot/aloha_sim_transfer_cube_human",
                default_prompt="Transfer cube",
                use_delta_joint_actions=False,
                adapt_to_pi=False,
            ),
            weight_loader=weight_loaders.CheckpointWeightLoader(_PI0_GS),
            num_train_steps=20_000,
        ),
        TrainConfig(
            name="pi0_droid",
            model=pi0_config.Pi0Config(action_horizon=10),
            data=LeRobotDROIDDataConfig(repo_id="lerobot/droid_100"),
            weight_loader=weight_loaders.CheckpointWeightLoader(_PI0_GS),
        ),
        TrainConfig(
            name="pi0_fast_droid",
            model=pi0_fast_config.Pi0FASTConfig(action_dim=8, action_horizon=10),
            data=LeRobotDROIDDataConfig(repo_id="lerobot/droid_100"),
            weight_loader=weight_loaders.CheckpointWeightLoader(_PI0_FAST_GS),
        ),
        TrainConfig(
            name="pi0_fast_full_droid_finetune",
            model=pi0_fast_config.Pi0FASTConfig(action_dim=8, action_horizon=16, max_token_len=180),
            data=RLDSDroidDataConfig(repo_id="droid", rlds_data_dir="<path_to_droid_rlds_dataset>"),
            weight_loader=weight_loaders.CheckpointWeightLoader(_PI0_FAST_GS),
            lr_schedule=_optimizer.CosineDecaySchedule(
                warmup_steps=1_000, peak_lr=5e-5, decay_steps=1_000_000, decay_lr=5e-5
            ),
            num_train_steps=100_000,
            batch_size=256,
            log_interval=100,
            save_interval=5000,
            keep_period=20_000,
            num_workers=0,
        ),
        TrainConfig(
            name="pi0_libero",
            model=pi0_config.Pi0Config(),
            data=LeRobotLiberoDataConfig(**libero, extra_delta_transform=True),
            weight_loader=weight_loaders.CheckpointWeightLoader(_PI0_GS),
            num_train_steps=30_000,
        ),
        TrainConfig(
            name="pi0_libero_low_mem_finetune",
            model=pi0_config.Pi0Config(paligemma_variant="gemma_2b_lora", action_expert_variant="gemma_300m_lora"),
            data=LeRobotLiberoDataConfig(**libero, extra_delta_transform=True),
            weight_loader=weight_loaders.CheckpointWeightLoader(_PI0_GS),
            num_train_steps=30_000,
            ema_decay=None,
        ),
        TrainConfig(
            name="pi0_fast_libero",
            model=pi0_fast_config.Pi0FASTConfig(action_dim=7, action_horizon=10, max_token_len=180),
            data=LeRobotLiberoDataConfig(**libero),
            weight_loader=weight_loaders.CheckpointWeightLoader(_PI0_FAST_GS),
            num_train_steps=30_000,
        ),
        TrainConfig(
            name="pi0_fast_libero_low_mem_finetune",
            model=pi0_fast_config.Pi0FASTConfig(
                paligemma_variant="gemma_2b_lora", action_dim=7, action_horizon=10, max_token_len=180
            ),
            data=LeRobotLiberoDataConfig(**libero),
            weight_loader=weight_loaders.CheckpointWeightLoader(_PI0_FAST_GS),
            num_train_steps=30_000,
            ema_decay=None,
        ),
    ]


def _droid_transforms(model_type: _model.ModelType):
    def factory(model_config) -> _transforms.Group:
        return _transforms.Group(
            inputs=[droid_policy.DroidInputs(model_type=model_type)],
            outputs=[droid_policy.DroidOutputs()],
        )

    return factory


def _roboarena_configs() -> list[_config.TrainConfig]:
    """The RoboArena DROID baselines (``kai0_tpu/training/misc/roboarena_config.py``), inference configs."""
    TrainConfig = _config.TrainConfig

    def droid_data(model_type=_model.ModelType.PI0_FAST):
        return _config.SimpleDataConfig(
            assets=_config.AssetsConfig(asset_id="droid"),
            data_transforms=_droid_transforms(model_type),
            base_config=_config.DataConfig(prompt_from_task=True),
        )

    fast = pi0_fast_config.Pi0FASTConfig
    return [
        # RT-2 / OpenVLA-style binning tokenizer, trained from PaliGemma.
        TrainConfig(
            name="paligemma_binning_droid",
            model=fast(action_dim=8, action_horizon=15, max_token_len=400,
                       fast_model_tokenizer=_tokenizer.BinningTokenizer),
            data=droid_data(),
        ),
        # Universal FAST+ tokenizer.
        TrainConfig(name="paligemma_fast_droid", model=fast(action_dim=8, action_horizon=15), data=droid_data()),
        # A FAST tokenizer trained on DROID.
        TrainConfig(
            name="paligemma_fast_specialist_droid",
            model=fast(action_dim=8, action_horizon=15, fast_model_tokenizer=_tokenizer.FASTTokenizer,
                       fast_model_tokenizer_kwargs={"fast_tokenizer_path": "KarlP/fast_droid_specialist"}),
            data=droid_data(),
        ),
        # FSQ (VQ) action tokenizer.
        TrainConfig(
            name="paligemma_vq_droid",
            model=fast(action_dim=8, action_horizon=15, fast_model_tokenizer=_tokenizer.FSQTokenizer,
                       fast_model_tokenizer_kwargs={"fsq_tokenizer_path": None}),
            data=droid_data(),
        ),
        # π₀-style flow VLA trained on DROID from PaliGemma.
        TrainConfig(
            name="paligemma_diffusion_droid",
            model=pi0_config.Pi0Config(action_horizon=10, action_dim=8),
            data=droid_data(_model.ModelType.PI0),
        ),
    ]


def _polaris_configs() -> list[_config.TrainConfig]:
    """The PolaRiS DROID joint-position configs (``kai0_tpu/training/misc/polaris_config.py``) but the π₀.₅ one
    (``PENDING``): DROID (0.9) + the PolaRiS cotrain set (0.1) over the RLDS stream, and a binning baseline."""
    TrainConfig = _config.TrainConfig
    datasets = (
        RLDSDataset(name="droid", version="1.0.1", weight=0.9),
        RLDSDataset(name="polaris_droid_cotrain_dataset", version="1.0.0", weight=0.1),
    )

    def polaris_train(name: str, model, *, num_train_steps: int = 1_000) -> _config.TrainConfig:
        return TrainConfig(
            name=name,
            model=model,
            data=RLDSDroidDataConfig(
                assets=_config.AssetsConfig(
                    assets_dir=f"gs://openpi-assets/checkpoints/polaris/{name}/assets", asset_id="droid"
                ),
                datasets=datasets,
                rlds_data_dir="<path_to_droid_rlds_dataset>",
                action_space=DroidActionSpace.JOINT_POSITION,
            ),
            weight_loader=weight_loaders.CheckpointWeightLoader(f"gs://openpi-assets/checkpoints/polaris/{name}/params"),
            lr_schedule=_optimizer.CosineDecaySchedule(
                warmup_steps=1_000, peak_lr=5e-5, decay_steps=1_000_000, decay_lr=5e-5
            ),
            num_train_steps=num_train_steps,
            batch_size=128,
            log_interval=100,
            save_interval=1000,
            keep_period=1000,
            num_workers=0,  # the RLDS stream does its own parallelism
        )

    return [
        polaris_train("pi0_fast_droid_jointpos_polaris", pi0_fast_config.Pi0FASTConfig(action_dim=8, action_horizon=15)),
        polaris_train("pi0_droid_jointpos_polaris", pi0_config.Pi0Config(action_horizon=15, action_dim=8)),
        polaris_train(
            "pi0_droid_jointpos_100k_polaris", pi0_config.Pi0Config(action_horizon=15, action_dim=8),
            num_train_steps=100_000,
        ),
        # The binning baseline at joint-position actions.
        TrainConfig(
            name="paligemma_binning_droid_jointpos",
            model=pi0_fast_config.Pi0FASTConfig(action_dim=8, action_horizon=15, max_token_len=400,
                                                fast_model_tokenizer=_tokenizer.BinningTokenizer),
            data=_config.SimpleDataConfig(
                assets=_config.AssetsConfig(asset_id="droid"),
                data_transforms=_droid_transforms(_model.ModelType.PI0_FAST),
                base_config=_config.DataConfig(prompt_from_task=True),
            ),
        ),
    ]


def configs() -> list[_config.TrainConfig]:
    TrainConfig = _config.TrainConfig
    return [
        *_pi0_configs(),
        TrainConfig(
            name="pi05_aloha",
            model=pi0_config.Pi0Config(pi05=True),
            data=LeRobotAlohaDataConfig(assets=_config.AssetsConfig(asset_id="trossen")),
            weight_loader=weight_loaders.CheckpointWeightLoader(_PI05_GS),
        ),
        TrainConfig(
            name="pi05_aloha_pen_uncap",
            model=pi0_config.Pi0Config(pi05=True),
            data=LeRobotAlohaDataConfig(
                repo_id="physical-intelligence/aloha_pen_uncap_diverse",
                default_prompt="uncap the pen",
                assets=_config.AssetsConfig(
                    assets_dir="gs://openpi-assets/checkpoints/pi05_base/assets", asset_id="trossen"
                ),
            ),
            weight_loader=weight_loaders.CheckpointWeightLoader(_PI05_GS),
            num_train_steps=20_000,
        ),
        TrainConfig(
            name="pi05_droid",
            model=pi0_config.Pi0Config(pi05=True, action_horizon=16),
            data=LeRobotDROIDDataConfig(repo_id="lerobot/droid_100"),
            lr_schedule=_optimizer.CosineDecaySchedule(peak_lr=5e-5, decay_lr=5e-5 / 10),
            weight_loader=weight_loaders.CheckpointWeightLoader(_PI05_GS),
        ),
        TrainConfig(
            name="pi05_droid_finetune",
            model=pi0_config.Pi0Config(pi05=True, action_dim=32, action_horizon=16),
            data=LeRobotDROIDDataConfig(
                repo_id="your_hf_username/my_droid_dataset",
                base_config=_config.DataConfig(prompt_from_task=True),
                assets=_config.AssetsConfig(
                    assets_dir="gs://openpi-assets/checkpoints/pi05_droid/assets", asset_id="droid"
                ),
            ),
            weight_loader=weight_loaders.CheckpointWeightLoader("gs://openpi-assets/checkpoints/pi05_droid/params"),
            num_train_steps=20_000,
            batch_size=32,
        ),
        TrainConfig(
            name="pi05_libero",
            model=pi0_config.Pi0Config(pi05=True),
            data=LeRobotLiberoDataConfig(repo_id="physical-intelligence/libero"),
            weight_loader=weight_loaders.CheckpointWeightLoader(_PI05_GS),
            num_train_steps=30_000,
        ),
        _kai0_finetune("pi05_flatten_fold_normal", "flatten_fold"),
        _kai0_finetune("pi05_tee_shirt_sort_normal", "tee_shirt_sort"),
        _kai0_finetune("pi05_hang_cloth_normal", "hang_cloth"),
        _kai0_finetune("pi05_flatten_fold_awbc", "flatten_fold", awbc=True),
        _kai0_finetune("pi05_tee_shirt_sort_awbc", "tee_shirt_sort", awbc=True),
        _kai0_finetune("pi05_hang_cloth_awbc", "hang_cloth", awbc=True),
        _kai0_advantage("ADVANTAGE_TORCH_KAI0_FLATTEN_FOLD", "flatten_fold"),
        # PI06 variant: the same estimator, evaluated on absolute values (1-timestep mode).
        _kai0_advantage("ADVANTAGE_TORCH_PI06_FLATTEN_FOLD", "flatten_fold"),
        # RTC inference config (serving only; the data and weights of the flatten-fold fine-tune).
        TrainConfig(
            name="pi05_rtc_flatten_fold_inference",
            model=pi0_rtc_config.Pi0RTCConfig(pi05=True),
            data=LerobotAgilexDataConfig(
                repo_id="data/FlattenFold/base",
                default_prompt="Flatten and fold the cloth.",
                use_delta_joint_actions=False,
            ),
            weight_loader=weight_loaders.CheckpointWeightLoader(_PI05_BASE_CKPT),
            **_KAI0_LOOP,
        ),
        *_roboarena_configs(),
        *_polaris_configs(),
    ]
