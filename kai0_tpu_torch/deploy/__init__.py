"""Train-Deploy Alignment's robot edge: latency-compensated client buffers, the RTC client and DAgger tooling.

The port's copy of ``kai0_tpu/deploy``:

- ``buffers``: ``StreamActionBuffer`` (temporal-smoothing crossfade),
  ``TemporalEnsemblingBuffer`` (ACT-style exponential aggregation),
  ``DelayEstimator`` and ``rtc_align_chunks`` (real-time-chunking execution);
- ``native_buffers``: the first two over the C++ core of ``kai0_tpu_torch/native``;
- ``rtc_client``: RTC payload assembly and latency bookkeeping around any policy
  with ``infer`` (the websocket client or an in-process ``Policy``);
- ``dagger``: the policy-in-the-loop episode collector writing HDF5 and mp4
  (converted to LeRobot by ``augment.convert_h5``), its keyboard state machine,
  the Kalman filter and the master-arm hand-off.

``make_stream_buffer`` and ``make_ensembling_buffer`` differ from JAX's: with
``prefer_native=True`` they return the C++ buffer or raise (a failed build
raises with the compiler's stderr), where JAX's fall back to the Python buffer
without a word. ``prefer_native=False``, or ``KAI0_DISABLE_NATIVE`` set, gives
the Python buffer.
"""

from kai0_tpu_torch.deploy.buffers import (  # noqa: F401
    DelayEstimator,
    StreamActionBuffer,
    TemporalEnsemblingBuffer,
    rtc_align_chunks,
)


def _native_wanted(prefer_native: bool) -> bool:
    from kai0_tpu_torch import native

    return prefer_native and native.enabled()


def make_stream_buffer(*, smooth_method: str = "temporal", prefer_native: bool = True):
    """The C++ smoothing buffer (GIL-free locking), or the Python one when ``prefer_native`` is false or
    ``KAI0_DISABLE_NATIVE`` is set."""
    if _native_wanted(prefer_native):
        from kai0_tpu_torch.deploy.native_buffers import NativeStreamActionBuffer

        return NativeStreamActionBuffer(smooth_method=smooth_method)
    return StreamActionBuffer(smooth_method=smooth_method)


def make_ensembling_buffer(*, chunk_size: int = 50, exp_weight_m: float = 0.01, prefer_native: bool = True):
    """The C++ ensembling buffer, or the Python one when ``prefer_native`` is false or ``KAI0_DISABLE_NATIVE`` is
    set."""
    if _native_wanted(prefer_native):
        from kai0_tpu_torch.deploy.native_buffers import NativeTemporalEnsemblingBuffer

        return NativeTemporalEnsemblingBuffer(chunk_size=chunk_size, exp_weight_m=exp_weight_m)
    return TemporalEnsemblingBuffer(chunk_size=chunk_size, exp_weight_m=exp_weight_m)
