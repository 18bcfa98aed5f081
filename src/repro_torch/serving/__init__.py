"""Serving: snapshots published at chunk boundaries (``snapshot``), the
predict-only fast paths of the learner families (``predict``) and the
micro-batching model server (``server``)."""

from repro_torch.serving.predict import make_predict_fn, reference_predict
from repro_torch.serving.server import ModelServer, Request, ServeConfig
from repro_torch.serving.snapshot import (Snapshot, SnapshotPublisher,
                                          model_state_of, tenant_state_of)

__all__ = ["Snapshot", "SnapshotPublisher", "model_state_of",
           "tenant_state_of", "make_predict_fn", "reference_predict",
           "ModelServer", "Request", "ServeConfig"]
