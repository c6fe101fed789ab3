"""The ``precision=`` keyword where the JAX package takes it: ``"highest"``
(what the port computes: float32 products) gives the call without the
keyword bit for bit, and any other value raises a ``ValueError`` that names
it, so a request for less precision is never served at full precision."""

import numpy as np
import pytest
import torch

from reductive_tpu_torch import Pq, linalg, search
from reductive_tpu_torch.pq import primitives

from torch_port_util import make_pq_data, orthonormal, t

CB, X = make_pq_data(7, 12, 2, 4, 3)
PQ = Pq(codebooks=t(CB), projection=t(orthonormal(8, 6)))
CODES = PQ.quantize_batch(t(X))

ENTRIES = {
    "Pq.quantize_batch": lambda **kw: PQ.quantize_batch(t(X), **kw),
    "Pq.quantize_vector": lambda **kw: PQ.quantize_vector(t(X[0]), **kw),
    "Pq.reconstruct_batch": lambda **kw: PQ.reconstruct_batch(CODES, **kw),
    "Pq.reconstruct": lambda **kw: PQ.reconstruct(CODES[0], **kw),
    "primitives.quantize_batch": lambda **kw: primitives.quantize_batch(t(CB), t(X), **kw),
    "primitives.quantize": lambda **kw: primitives.quantize(t(CB), t(X[0]), **kw),
    "linalg.squared_euclidean_distance":
        lambda **kw: linalg.squared_euclidean_distance(t(X), t(X[:5]), **kw),
    "linalg.euclidean_distance": lambda **kw: linalg.euclidean_distance(t(X[0] + 1), t(X), **kw),
    "linalg.covariance": lambda **kw: linalg.covariance(t(X), **kw),
    "search.adc_tables": lambda **kw: search.adc_tables(PQ, t(X), **kw),
}


@pytest.mark.parametrize("entry", list(ENTRIES))
def test_precision_keyword(entry):
    call = ENTRIES[entry]
    plain = call()
    highest = call(precision="highest")
    assert highest.dtype == plain.dtype
    assert torch.equal(highest, plain)
    for other in ("default", "high", None):
        with pytest.raises(ValueError, match=f"precision={other!r}.*float32 only"):
            call(precision=other)
    assert np.isfinite(plain.to(torch.float64).numpy()).all()
