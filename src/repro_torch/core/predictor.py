"""DNNAbacus — the end-to-end predictor (paper §3).

Pipeline: ProfileRecords -> [structure-independent features | NSM vector
(or WL graph embedding)] -> AutoML-lite ensembles for time and memory.

``save``/``load`` persist everything (featurizer vocab + serialized tree
ensembles) as JSON so the launcher's admission control can run without
refitting.

Port of ``repro.core.predictor`` on the port's copies of the AutoML, feature
and graph-embedding modules and its own NSM featurizer: the same records
give bit-identical predictions, and ``to_dict`` gives the reference's JSON,
so either package loads the other's predictor.

The targets differ from the reference's. A record profiled by the port
(``PLATFORM_TORCH_CUDA``) holds as ``mem_bytes`` the torch allocator's peak
on the card, which includes the cuDNN workspaces taken through the caching
allocator; the reference's records hold XLA's ``memory_analysis`` bytes.
They measure different things: never fit one predictor on a mix of the two.

``service()`` fronts the predictor with the port's ``PredictionService``
(``repro_torch.serve.prediction_service``), whose tracer is the port's
``trace_query``; ``predict_config()`` answers one query through it.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import nsm as nsm_lib
from repro_torch.core.automl.search import FittedEnsemble, fit_automl
from repro_torch.core.features import ProfileRecord, design_matrix, mre, targets
from repro_torch.core.graphfeat import WLGraphEmbedder

# torch.cuda.get_device_properties(0).total_memory on an NVIDIA H100 80GB HBM3
# (700 W), torch 2.11 / CUDA 12.8: the admission budget of one card
HBM_PER_DEVICE = 85_017_493_504


class DNNAbacus:
    def __init__(self, representation: str = "nsm", max_vocab: int = 28,
                 seed: int = 0):
        assert representation in ("nsm", "ge", "none")
        self.representation = representation
        self.seed = seed
        self.nsm_feat = (nsm_lib.NSMFeaturizer(max_vocab=max_vocab)
                         if representation == "nsm" else None)
        self.ge_feat = (WLGraphEmbedder() if representation == "ge" else None)
        self.time_model: Optional[FittedEnsemble] = None
        self.mem_model: Optional[FittedEnsemble] = None
        self._service = None  # lazily created PredictionService

    # -- featurization ------------------------------------------------------
    def _x(self, records: Sequence[ProfileRecord]) -> np.ndarray:
        return design_matrix(list(records), self.nsm_feat, self.ge_feat)

    def fit(self, records: Sequence[ProfileRecord], val_frac: float = 0.2,
            candidate_factory=None) -> "DNNAbacus":
        """``candidate_factory(seed) -> [models]`` builds a FRESH candidate
        pool per target (the time and memory ensembles must not share
        model objects)."""
        if self.nsm_feat is not None:
            self.nsm_feat.fit([r.nsm_edges for r in records])
        x = self._x(records)
        t, m = targets(list(records))
        mk = candidate_factory or (lambda seed: None)
        self.time_model = fit_automl(x, t, val_frac=val_frac, seed=self.seed,
                                     candidates=mk(self.seed))
        self.mem_model = fit_automl(x, m, val_frac=val_frac,
                                    seed=self.seed + 1,
                                    candidates=mk(self.seed + 1))
        return self

    def refit(self, records: Sequence[ProfileRecord], val_frac: float = 0.2,
              candidate_factory=None) -> "DNNAbacus":
        """A NEW predictor re-fit on ``records`` (self is untouched).

        The online-refit loop publishes immutable model generations, so
        refitting must never mutate the ensembles a live server is
        predicting with mid-tick — hence a fresh ``DNNAbacus``. Without
        a ``candidate_factory`` the candidate pools are unfitted clones
        of the models the original AutoML search *selected* (per
        target), so a refit re-estimates parameters on fresh data
        without re-running model selection over the whole pool.
        """
        new = DNNAbacus(representation=self.representation,
                        max_vocab=(self.nsm_feat.max_vocab
                                   if self.nsm_feat is not None else 28),
                        seed=self.seed)
        if candidate_factory is not None or self.time_model is None:
            return new.fit(records, val_frac=val_frac,
                           candidate_factory=candidate_factory)
        from repro_torch.core.automl.models import clone_unfitted
        records = list(records)
        if new.nsm_feat is not None:
            new.nsm_feat.fit([r.nsm_edges for r in records])
        x = new._x(records)
        t, m = targets(records)
        new.time_model = fit_automl(
            x, t, val_frac=val_frac, seed=self.seed,
            candidates=[clone_unfitted(c) for c in self.time_model.models])
        new.mem_model = fit_automl(
            x, m, val_frac=val_frac, seed=self.seed + 1,
            candidates=[clone_unfitted(c) for c in self.mem_model.models])
        return new

    def predict(self, records: Sequence[ProfileRecord]):
        x = self._x(records)
        return self.time_model.predict(x), self.mem_model.predict(x)

    def evaluate(self, records: Sequence[ProfileRecord]) -> Dict[str, float]:
        t_pred, m_pred = self.predict(records)
        t, m = targets(list(records))
        return {"time_mre": mre(t_pred, t), "mem_mre": mre(m_pred, m)}

    # -- launcher integration ------------------------------------------------
    def service(self, store=None) -> "object":
        """The (lazily created) PredictionService fronting this predictor.

        All online queries go through it: repeated (config, batch, seq)
        questions hit its trace cache instead of re-building the model.
        ``store`` (a ``repro_torch.serve.trace_store.TraceStore``) backs the
        cache with cross-process persistence; it only takes effect when the
        service is first created (or has no store yet): an already attached
        store is never silently swapped out. For other custom options (budget, cache
        size, tracer) construct a ``PredictionService`` directly —
        recreating it here would throw away the warm trace cache.
        """
        if self._service is None:
            from repro_torch.serve.prediction_service import PredictionService
            self._service = PredictionService(self, store=store)
        elif store is not None and self._service.store is None:
            self._service.store = store
        return self._service

    def predict_config(self, cfg, batch: int, seq: int) -> Dict:
        """Admission-control estimate for a (ModelConfig, batch, seq) job.

        Returns the service estimate dict: ``time_s``, ``memory_bytes``,
        ``hbm_budget`` (floats) plus ``model`` (str) / ``admitted`` (bool).
        """
        return self.service().predict_one(cfg, batch, seq)

    # -- persistence ----------------------------------------------------------
    def to_dict(self) -> Dict:
        """JSON-safe snapshot of the fitted predictor.

        The single serialization seam: ``save``/``load`` persist it to
        disk, and the RPC fleet (``repro.serve.rpc``) ships it over the
        wire to adopt model generations in remote replica processes.
        """
        return {
            "representation": self.representation,
            "seed": self.seed,
            "vocab": self.nsm_feat.vocab if self.nsm_feat else None,
            "time_model": self.time_model.to_dict(),
            "mem_model": self.mem_model.to_dict(),
        }

    @classmethod
    def from_dict(cls, d: Dict) -> "DNNAbacus":
        ab = cls(representation=d["representation"], seed=d["seed"])
        if ab.nsm_feat is not None:
            ab.nsm_feat.vocab = d["vocab"]
        ab.time_model = FittedEnsemble.from_dict(d["time_model"])
        ab.mem_model = FittedEnsemble.from_dict(d["mem_model"])
        return ab

    def save(self, path: str) -> None:
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path + ".json", "w") as f:
            json.dump(self.to_dict(), f)

    @classmethod
    def load(cls, path: str) -> "DNNAbacus":
        with open(path + ".json") as f:
            return cls.from_dict(json.load(f))
