"""Normalization statistics: streaming accumulation + norm_stats.json (de)serialization.

Behavioral parity with the reference's ``src/openpi/shared/normalize.py`` (RunningStats
:17-117, JSON io :124-147): streaming mean / mean-of-squares, adaptive 5000-bin
histograms for on-the-fly 1%/99% quantiles, and a JSON format that is byte-layout
compatible with the reference's ``norm_stats.json`` files (pydantic there, plain
dataclass + json here — same structure: ``{"norm_stats": {key: {mean, std, q01, q99}}}``).
"""

from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np

# Histogram resolution for the streaming quantile estimate, and the padding added
# around the first batch's observed range so its extremes land strictly inside the
# outermost bins. Both values participate in the bit-parity contract with the
# reference's norm-stats pipeline — do not change them.
_QUANTILE_BINS = 5000
_EDGE_PAD = 1e-10


@dataclasses.dataclass
class NormStats:
    mean: np.ndarray
    std: np.ndarray
    q01: np.ndarray | None = None  # 1st percentile
    q99: np.ndarray | None = None  # 99th percentile

    def __post_init__(self):
        self.mean = np.asarray(self.mean)
        self.std = np.asarray(self.std)
        if self.q01 is not None:
            self.q01 = np.asarray(self.q01)
        if self.q99 is not None:
            self.q99 = np.asarray(self.q99)


class RunningStats:
    """Single-pass statistics over a stream of [..., D] batches.

    Two accumulators per dimension: an incremental mean / mean-of-x² pair (for
    mean/std) and a fixed-bin histogram (for approximate q01/q99). The histogram
    covers the observed [lo, hi] range; when a later batch falls outside it, the
    counts are re-binned onto the widened range before the batch is deposited.

    The *sequence* of floating-point operations here is a parity contract with the
    reference pipeline (``src/openpi/shared/normalize.py:30-71``): fed the same
    batches in the same order, this class reproduces its statistics bit-for-bit
    (see ``tests/test_normalize.py``). Keep the update order — widen range, then
    bump count, then fold the batch means, then deposit into the histogram — and
    keep all reductions per-batch (never over the concatenated stream).
    """

    def __init__(self):
        self._seen = 0  # total vectors folded in so far
        self._mu: np.ndarray | None = None  # running E[x], shape [D]
        self._mu_x2: np.ndarray | None = None  # running E[x²], shape [D]
        self._lo: np.ndarray | None = None  # per-dim observed min
        self._hi: np.ndarray | None = None  # per-dim observed max
        self._hist: list[np.ndarray] | None = None  # per-dim bin counts
        self._edges: list[np.ndarray] | None = None  # per-dim bin edges, len bins+1

    @property
    def dim(self) -> int | None:
        return None if self._mu is None else int(self._mu.size)

    @property
    def count(self) -> int:
        return self._seen

    def update(self, batch: np.ndarray) -> None:
        batch = np.asarray(batch)
        batch = batch.reshape(-1, batch.shape[-1])
        count, dim = batch.shape

        if self._seen == 0:
            self._start(batch)
        else:
            if dim != self._mu.size:
                raise ValueError(f"RunningStats was started with dim {self._mu.size}, got a batch of dim {dim}.")
            self._widen_range(batch)

        self._seen += count
        # Incremental mean folds: mu ← mu + (batch_mu − mu)·(n_batch / n_total).
        frac = count / self._seen
        self._mu += (np.mean(batch, axis=0) - self._mu) * frac
        self._mu_x2 += (np.mean(batch**2, axis=0) - self._mu_x2) * frac

        for d in range(dim):
            self._hist[d] += np.histogram(batch[:, d], bins=self._edges[d])[0]

    def _start(self, batch: np.ndarray) -> None:
        dim = batch.shape[1]
        self._mu = np.mean(batch, axis=0)
        self._mu_x2 = np.mean(batch**2, axis=0)
        self._lo = np.min(batch, axis=0)
        self._hi = np.max(batch, axis=0)
        self._hist = [np.zeros(_QUANTILE_BINS) for _ in range(dim)]
        self._edges = [
            np.linspace(self._lo[d] - _EDGE_PAD, self._hi[d] + _EDGE_PAD, _QUANTILE_BINS + 1) for d in range(dim)
        ]

    def _widen_range(self, batch: np.ndarray) -> None:
        batch_hi = np.max(batch, axis=0)
        batch_lo = np.min(batch, axis=0)
        grew = bool(np.any(batch_hi > self._hi)) or bool(np.any(batch_lo < self._lo))
        self._hi = np.maximum(self._hi, batch_hi)
        self._lo = np.minimum(self._lo, batch_lo)
        if grew:
            # Re-deposit existing counts onto edges spanning the new range. Each old
            # bin's count lands in the new bin containing its left edge — the same
            # approximation the reference applies, so rebinned histograms stay
            # bit-identical across implementations.
            for d in range(len(self._hist)):
                widened = np.linspace(self._lo[d], self._hi[d], _QUANTILE_BINS + 1)
                self._hist[d] = np.histogram(self._edges[d][:-1], bins=widened, weights=self._hist[d])[0]
                self._edges[d] = widened

    def _quantile(self, q: float) -> np.ndarray:
        """Left edge of the first bin whose cumulative count reaches q·N, per dim."""
        rank = q * self._seen
        return np.array(
            [edges[np.searchsorted(np.cumsum(hist), rank)] for hist, edges in zip(self._hist, self._edges, strict=True)]
        )

    def get_statistics(self) -> NormStats:
        if self._seen < 2:
            raise ValueError(f"Need at least 2 vectors to report statistics, have {self._seen}.")
        std = np.sqrt(np.maximum(0, self._mu_x2 - self._mu**2))
        return NormStats(mean=self._mu, std=std, q01=self._quantile(0.01), q99=self._quantile(0.99))


def _stats_to_jsonable(stats: NormStats) -> dict:
    out = {"mean": np.asarray(stats.mean).tolist(), "std": np.asarray(stats.std).tolist()}
    out["q01"] = np.asarray(stats.q01).tolist() if stats.q01 is not None else None
    out["q99"] = np.asarray(stats.q99).tolist() if stats.q99 is not None else None
    return out


def _stats_from_jsonable(d: dict) -> NormStats:
    return NormStats(
        mean=np.asarray(d["mean"]),
        std=np.asarray(d["std"]),
        q01=np.asarray(d["q01"]) if d.get("q01") is not None else None,
        q99=np.asarray(d["q99"]) if d.get("q99") is not None else None,
    )


def serialize_json(norm_stats: dict[str, NormStats]) -> str:
    return json.dumps({"norm_stats": {k: _stats_to_jsonable(v) for k, v in norm_stats.items()}}, indent=2)


def deserialize_json(data: str) -> dict[str, NormStats]:
    parsed = json.loads(data)
    if "norm_stats" not in parsed:
        raise ValueError("norm_stats JSON missing 'norm_stats' key")
    return {k: _stats_from_jsonable(v) for k, v in parsed["norm_stats"].items()}


def save(directory: pathlib.Path | str, norm_stats: dict[str, NormStats]) -> None:
    path = pathlib.Path(directory) / "norm_stats.json"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(serialize_json(norm_stats))


def load(directory: pathlib.Path | str) -> dict[str, NormStats]:
    path = pathlib.Path(directory) / "norm_stats.json"
    if not path.exists():
        raise FileNotFoundError(f"Norm stats file not found at: {path}")
    return deserialize_json(path.read_text())
