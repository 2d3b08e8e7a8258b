"""The port's diverse beam search (``generate(..., sample_method="dbs")``)
against the JAX package's, on the narrow flagship decoder of
``test_torch_sampling`` (emb 64, vocab 50, tied, jittered by 0.1 as
``test_torch_hf_api.py`` jitters it) and
seeded random encoder memory: beam 6 in groups of 2 and 3, diversity
lambda 0.5 and 1.0, ``group_nbest`` on ([B, 6, L]) and off ([B, G, L]).
DBS draws nothing, so tokens must be equal; scores within 1e-5.  Both
APIs' "dbs" are held against the JAX APIs in ``test_torch_hf_api.py``
and ``test_torch_tempgru_api.py``."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from audiocaption_tpu.models.captioner import generate as j_generate

from audiocaption_tpu_torch.models.captioner import generate

from test_torch_sampling import L, make_decoders, port_enc

K = 6
JITTER = 0.1


@pytest.fixture(scope="module")
def decoders():
    return make_decoders(JITTER)


@pytest.mark.parametrize("group_nbest", [True, False])
@pytest.mark.parametrize("lam", [0.5, 1.0])
@pytest.mark.parametrize("group_size", [2, 3])
def test_dbs_matches_jax(decoders, group_size, lam, group_nbest):
    port, jmodel, jvars, enc = decoders
    kw = dict(sample_method="dbs", beam_size=K, group_size=group_size,
              diversity_lambda=lam, group_nbest=group_nbest, max_length=L)
    jenc = {k: jnp.asarray(v) for k, v in enc.items()}
    # the JAX search expands fc_emb too (its transformer ignores it)
    jenc["fc_emb"] = jnp.zeros(enc["attn_emb"].shape[::2], jnp.float32)
    want = j_generate(jmodel, jvars, enc_override=jenc, **kw)
    got = generate(port, enc=port_enc(enc), **kw)
    seq = np.asarray(want["seq"])
    B = enc["attn_emb"].shape[0]
    assert seq.shape == (B, K if group_nbest else group_size, L)
    np.testing.assert_array_equal(got["seq"].numpy(), seq)
    np.testing.assert_allclose(got["score"].numpy(),
                               np.asarray(want["score"]), rtol=0, atol=1e-5)
    # the searches are not degenerate: the beams differ
    assert len({tuple(s) for row in seq for s in row}) > seq.shape[0]


def test_dbs_leaves_the_caller_cache_alone(decoders):
    """Inactive groups keep their old caches: the search copies the
    caches before each step, so the step's in-place writes touch only
    the copy, and a second call gives the same result."""
    port, _, _, enc = decoders
    a = generate(port, enc=port_enc(enc), sample_method="dbs", beam_size=K,
                 max_length=L)
    b = generate(port, enc=port_enc(enc), sample_method="dbs", beam_size=K,
                 max_length=L)
    assert torch.equal(a["seq"], b["seq"])
    assert a["seq"].shape == (enc["attn_emb"].shape[0], K, L)
