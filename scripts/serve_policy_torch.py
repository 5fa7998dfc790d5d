"""Serve a trained π₀.₅ policy over websocket with the PyTorch port on a CUDA card.

The arguments of ``scripts/serve_policy.py``:

    python scripts/serve_policy_torch.py policy:checkpoint --policy.config=pi05_flatten_fold_normal \\
        --policy.dir=<checkpoint dir holding model.safetensors and assets/> --warmup --prompt-buckets=64,128

``--warmup`` captures the sampler's CUDA graph of every prompt bucket before
the listener starts; ``--int8`` quantizes the Gemma matmul weights;
``--max_batch`` > 1 coalesces concurrent requests into one batch of up to
that many (power-of-two sizes, one CUDA graph each; ``--batch_wait_ms`` holds
a batch's first request that long for others to join). An RTC config
(``pi05_rtc_flatten_fold_inference``) guides each chunk by the previous one a
request sends. The checkpoint directory is local (nothing is downloaded):
both ``--policy.*`` arguments are required, and ``--env`` is accepted but
picks no default checkpoint. ``--fsdp_devices`` raises: serving over several
cards is not ported yet. ``--device cpu`` serves on the host's CPU (slow; for
tests). The server and its codec need no package beyond torch and numpy.
"""

from __future__ import annotations

import argparse
import enum
import logging
import os
import socket
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from kai0_tpu_torch.policies import policy as _policy  # noqa: E402
from kai0_tpu_torch.policies import policy_config as _policy_config  # noqa: E402
from kai0_tpu_torch.serving import websocket_policy_server  # noqa: E402
from kai0_tpu_torch.training import config as _config  # noqa: E402


class EnvMode(enum.Enum):
    ALOHA = "aloha"
    ALOHA_SIM = "aloha_sim"
    DROID = "droid"
    LIBERO = "libero"


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("mode", nargs="?", default="", help="'policy:checkpoint' to serve a checkpoint")
    parser.add_argument("--env", type=lambda s: EnvMode[s.upper()], default=EnvMode.ALOHA_SIM,
                        help="accepted as the JAX script takes it; the port has no default checkpoint to pick by it")
    parser.add_argument("--default_prompt", "--default-prompt", default=None)
    parser.add_argument("--port", type=int, default=8000)
    parser.add_argument("--record", action="store_true")
    parser.add_argument("--warmup", action="store_true", help="capture the sampler's CUDA graphs before listening")
    parser.add_argument("--int8", action="store_true", help="int8 Gemma weights (half the weight bytes; slight action drift)")
    parser.add_argument(
        "--prompt-buckets",
        "--prompt_buckets",
        dest="prompt_buckets",
        default=None,
        help="comma-separated prompt-length buckets (e.g. '64,128'); trims trailing prompt padding to the smallest "
        "bucket >= the tokenized length, shrinking the prefill and KV cache (one CUDA graph per bucket)",
    )
    parser.add_argument("--max_batch", "--max-batch", dest="max_batch", type=int, default=1,
                        help="coalesce up to N concurrent client requests into one device batch (multi-robot "
                        "serving); batch sizes pad to powers of two")
    parser.add_argument("--batch_wait_ms", "--batch-wait-ms", dest="batch_wait_ms", type=float, default=0.0,
                        help="hold the first request of a batch up to this long so concurrent clients join it "
                        "(0 = only coalesce what is already queued)")
    parser.add_argument("--fsdp_devices", "--fsdp-devices", dest="fsdp_devices", type=int, default=1,
                        help="not ported yet: raises above 1")
    parser.add_argument("--device", default="cuda", help="torch device of the model")
    parser.add_argument("--policy.config", dest="policy_config", default=None)
    parser.add_argument("--policy.dir", dest="policy_dir", default=None)
    return parser.parse_args(argv)


def create_policy(args) -> _policy.Policy:
    if not (args.policy_config and args.policy_dir):
        raise ValueError(f"--env={args.env.value}: the port serves no default checkpoint (the JAX script's are remote); "
                         "name a train config and a local checkpoint directory with --policy.config and --policy.dir")
    if "://" in args.policy_dir:
        raise ValueError(f"{args.policy_dir}: the port reads local checkpoint directories only")
    return _policy_config.create_trained_policy(
        _config.get_config(args.policy_config),
        args.policy_dir,
        default_prompt=args.default_prompt,
        warmup=args.warmup,
        quantize=args.int8,
        prompt_buckets=[int(b) for b in args.prompt_buckets.split(",")] if args.prompt_buckets else None,
        fsdp_devices=args.fsdp_devices,
        max_batch=args.max_batch,
        batch_wait_ms=args.batch_wait_ms,
        device=args.device,
    )


def main(argv=None) -> None:
    args = parse_args(argv)
    policy = create_policy(args)
    policy_metadata = policy.metadata

    if args.record:
        policy = _policy.PolicyRecorder(policy, "policy_records")

    hostname = socket.gethostname()
    try:
        local_ip = socket.gethostbyname(hostname)
    except socket.gaierror:
        local_ip = "unknown"
    logging.info("Creating server (host: %s, ip: %s)", hostname, local_ip)

    server = websocket_policy_server.WebsocketPolicyServer(
        policy=policy, host="0.0.0.0", port=args.port, metadata=policy_metadata
    )
    server.serve_forever()


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO, force=True)
    main()
