"""Per-robot data config factories and the named configs the port serves.

Counterpart of ``kai0_tpu/training/robot_configs.py``: the LeRobot data
factories of Aloha, Libero, Agilex, ARX and DROID (each builds the repack,
robot and model transform groups and reads the norm stats), and every named
π₀.₅ config, among them the six kai0 task configs
(``pi05_{flatten_fold,tee_shirt_sort,hang_cloth}_{normal,awbc}``) and the
RTC serving config ``pi05_rtc_flatten_fold_inference`` and the two Stage
Advantage estimators ``ADVANTAGE_TORCH_{KAI0,PI06}_FLATTEN_FOLD``, with the training
fields of the JAX configs (weight loaders, step counts, batch sizes, workers,
retention). A weight loader reads a local ``model.safetensors``; the JAX
configs' ``gs://`` checkpoints raise when loaded (the port downloads nothing).

``PENDING`` names every config of the JAX registry that the port does not
have yet, with what it needs; ``config.get_config`` raises on those names.
"""

from __future__ import annotations

from collections.abc import Sequence
import dataclasses
import pathlib

from kai0_tpu_torch import transforms as _transforms
from kai0_tpu_torch.models import advantage as _advantage_model
from kai0_tpu_torch.models import pi0 as pi0_config
from kai0_tpu_torch.models import pi0_rtc as pi0_rtc_config
from kai0_tpu_torch.policies import agilex_policy, aloha_policy, arx_policy, droid_policy, libero_policy
from kai0_tpu_torch.training import config as _config
from kai0_tpu_torch.training import optimizer as _optimizer
from kai0_tpu_torch.training import weight_loaders

_PI0 = "the π₀ model (ROADMAP Queue 1 item 6)"
_FAST = "FAST (ROADMAP Queue 1 item 8)"
_RLDS = "the RLDS data loader (ROADMAP Queue 1 item 4)"
PENDING = {
    **dict.fromkeys(
        ("debug", "debug_restore", "debug_serve", "pi0_base", "pi0_aloha", "pi0_aloha_towel", "pi0_aloha_tupperware",
         "pi0_aloha_pen_uncap", "pi0_aloha_sim", "pi0_droid", "pi0_libero", "pi0_libero_low_mem_finetune",
         "paligemma_diffusion_droid", "pi0_droid_jointpos_polaris", "pi0_droid_jointpos_100k_polaris"),
        _PI0,
    ),
    **dict.fromkeys(
        ("pi0_fast_droid", "pi0_fast_full_droid_finetune", "pi0_fast_libero", "pi0_fast_libero_low_mem_finetune",
         "paligemma_binning_droid", "paligemma_fast_droid", "paligemma_fast_specialist_droid", "paligemma_vq_droid",
         "paligemma_binning_droid_jointpos", "pi0_fast_droid_jointpos_polaris"),
        _FAST,
    ),
    **dict.fromkeys(("pi05_full_droid_finetune", "pi05_droid_jointpos_polaris"), _RLDS),
}


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


def configs() -> list[_config.TrainConfig]:
    TrainConfig = _config.TrainConfig
    return [
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
    ]
