"""Streaming tokenized data pipeline with TStream-managed online statistics
(reference: ``repro/data/pipeline.py``).

The engine is a framework feature here: the ingestion stream keeps shared,
keyed, mutable state —

  * per-domain token and document counts  (READ_MODIFY add: mixture
                                           re-weighting)
  * per-domain duplicate counters         (tokens and documents flagged as
                                           duplicates)

Document-ingest events are state transactions over these tables; the
dual-mode engine evaluates each punctuation interval on the device, with
the sequential schedule's results, and no per-shard key partitioning.

Training batches are a pure function of (seed, step): the FT contract.  They
are drawn with numpy, so they are the reference's bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from ..core.blotter import AppSpec
from ..core.scheduler import DualModeEngine, EngineConfig
from ..core.types import ASSOC_FUNS, make_store
from ..kernels.runtime import resolve_device

N_DOMAINS = 16
W = 2  # value lanes: [token_count, doc_count]


def _stats_store(*, device=None, **_):
    return make_store([N_DOMAINS, N_DOMAINS], W, device=device)


def _gen(rng, n, **_):
    return dict(domain=rng.integers(0, N_DOMAINS, n).astype(np.int32),
                n_tokens=rng.integers(100, 2000, n).astype(np.float32),
                is_dup=(rng.random(n) < 0.1))


def _pre(ev):
    return ev


def _access(blt, eb):
    # table 0: per-domain token/doc counters
    ones = torch.ones_like(eb["n_tokens"])
    blt.read_modify(0, eb["domain"], torch.stack([eb["n_tokens"], ones], -1),
                    "add")
    # table 1: per-domain duplicate counters
    dup = eb["is_dup"].to(torch.float32)
    blt.read_modify(1, eb["domain"],
                    torch.stack([eb["n_tokens"] * eb["is_dup"], dup], -1),
                    "add")
    blt.read(0, eb["domain"])


def _post(eb, res):
    return dict(domain_tokens=res.post[..., 0, 0], accepted=~eb["is_dup"])


STATS_APP = AppSpec(
    name="ingest_stats", funs=ASSOC_FUNS, max_ops=4, width=W,
    make_store=_stats_store, gen_events=_gen, pre_process=_pre,
    state_access=_access, post_process=_post,
)


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    vocab: int = 256
    seq_len: int = 128
    batch: int = 8
    seed: int = 0
    punct_interval: int = 64


class SyntheticCorpus:
    """Deterministic multi-domain corpus (zipf unigrams per domain)."""

    def __init__(self, vocab: int, seed: int = 0):
        self.vocab = vocab
        self.seed = seed

    def doc(self, domain: int, idx: int, length: int) -> np.ndarray:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, domain, idx]))
        base = (domain * 997) % self.vocab
        toks = rng.zipf(1.5, size=length) % self.vocab
        return ((toks + base) % self.vocab).astype(np.int32)


class StreamingPipeline:
    """Packs documents into fixed-length training sequences and keeps the
    TStream stats engine updated per ingest batch, on ``device`` (None: the
    CUDA card)."""

    def __init__(self, cfg: PipelineConfig, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.corpus = SyntheticCorpus(cfg.vocab, cfg.seed)
        store = _stats_store(device=self.device)
        self.engine = DualModeEngine(STATS_APP, store,
                                     EngineConfig(scheme="tstream"),
                                     device=self.device)
        self.stats_values = store.values
        self._ts = 0

    def ingest(self, rng: np.random.Generator, n_docs: int) -> Dict:
        """One punctuation interval of ingest events -> engine step."""
        out, self.stats_values, _ = self.engine.step(
            self.stats_values, _gen(rng, n_docs), self._ts)
        self._ts += n_docs
        return out

    def mixture_weights(self) -> np.ndarray:
        """Current inverse-duplication mixture weights from shared state."""
        vals = self.stats_values.cpu().numpy()
        toks = vals[:N_DOMAINS, 0] + 1.0
        dups = vals[N_DOMAINS: 2 * N_DOMAINS, 0]
        w = toks / (toks + 2.0 * dups)
        return w / w.sum()

    def batch_for_step(self, step: int) -> Dict[str, torch.Tensor]:
        """Deterministic (seed, step) -> batch of int32 tensors on the
        pipeline's device; FT replay contract."""
        cfg = self.cfg
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, 7, step]))
        seqs = np.empty((cfg.batch, cfg.seq_len + 1), np.int32)
        for b in range(cfg.batch):
            dom = int(rng.integers(0, N_DOMAINS))
            doc = self.corpus.doc(dom, int(rng.integers(0, 1 << 20)),
                                  cfg.seq_len + 1)
            seqs[b] = doc
        return dict(
            tokens=torch.from_numpy(seqs[:, :-1].copy()).to(self.device),
            labels=torch.from_numpy(seqs[:, 1:].copy()).to(self.device))
