"""The port's HTS-AT encoder (``models/htsat.py``) against the JAX
package's, on the CPU.  JAX variables are drawn from a numpy seed on
flax's shapes (``test_torch_item8_wiring.random_variables``) and carried
across by ``models.convert.htsat_state_dict_from_jax`` (a whole captioner
by ``captioner_state_dict_from_jax``).

  * the helpers, as ``tests/test_htsat.py`` checks them in JAX:
    ``window_partition`` / ``window_reverse`` equal to JAX's and inverse
    of each other, ``relative_position_index`` and the shifted-window
    mask equal;
  * the time resize: ``wav2img`` of the port (a [T, 1024] weight matrix
    built in numpy, applied as a product) against the JAX ``_wav2img``
    (``jax.image.resize(..., "cubic")``) for T in {101, 500, 1001, 1023,
    1024} within 1e-5 relative, and the crop at T = 1100 exact;
  * the encoder at two small configurations with padded batches of mixed
    lengths: ``spec_size`` 256 (the published image, 1024 frames, four
    stages, the last a single window) and 128 (256 frames, the last
    stage's window clamped to its 4 x 4 grid), embed 8 or 12,
    two blocks a stage (shifted windows on the odd ones): ``attn_emb``
    and ``fc_emb`` within 1e-4 relative (to max(1, max |JAX|)),
    ``attn_emb_len`` equal; a second forward builds no constant table
    (the resize matrix and the shift masks are made once per shape and
    device);
  * one XE step of an HTS-AT (``spec_size`` 128, embed 8) + 1-layer
    ``TransformerDecoder`` captioner against the JAX ``make_train_step``
    (Adam, weight decay, the clip, scheduled sampling with teacher coins;
    dropout the identity on both sides), by ``test_torch_train_step``'s
    floors: loss relative 1e-5, raw gradient norm relative 1e-4,
    parameters 1e-5 (0.1% may miss), Adam moments 1e-4 of each tensor's
    largest (floor 1e-2 of the model's), ``bn0``'s statistics 1e-5
    relative;
  * a float32 greedy caption of that captioner token-exact against JAX;
  * the weight round trip at the published structure: a seeded dict
    under the HTSAT_Swin_Transformer keys -> JAX ``convert_htsat`` -> the
    port's inverse gives back the same arrays."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from audiocaption_tpu.models import htsat as JH
from audiocaption_tpu.models.captioner import generate as j_generate
from audiocaption_tpu.ops.frontend import CNN14_MEL_32K as J_MEL

from audiocaption_tpu_torch.models import htsat as TH
from audiocaption_tpu_torch.models.captioner import generate
from audiocaption_tpu_torch.models.convert import htsat_state_dict_from_jax
from audiocaption_tpu_torch.models.layers import device_table
from audiocaption_tpu_torch.ops.frontend import CNN14_MEL_32K

from test_torch_family import clips
from test_torch_item8_wiring import (
    check_xe_step, item8_captioner_pair, random_variables, xe_step_of)
from test_torch_panns import close

torch.set_num_threads(2)
SMALL = {256: dict(spec_size=256, embed_dim=8, depths=(2, 2, 2, 2),
                   num_heads=(1, 2, 2, 4)),
         128: dict(spec_size=128, embed_dim=12, depths=(2, 2, 2, 2),
                   num_heads=(2, 2, 4, 4))}


def test_window_helpers_match_jax():
    x = np.random.RandomState(0).randn(2, 16, 24, 3).astype(np.float32)
    w = TH.window_partition(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(
        w.numpy(), np.asarray(JH.window_partition(jnp.asarray(x), 8)))
    back = TH.window_reverse(w, 8, 16, 24)
    np.testing.assert_array_equal(back.numpy(), x)
    for win in (4, 7, 8):
        np.testing.assert_array_equal(TH.relative_position_index(win),
                                      JH.relative_position_index(win))
    for H, W, win, s in ((16, 16, 8, 4), (32, 16, 8, 4), (8, 8, 4, 2)):
        np.testing.assert_array_equal(TH.shift_mask(H, W, win, s),
                                      JH._shift_mask(H, W, win, s))


@pytest.mark.parametrize("T", [101, 500, 1001, 1023, 1024, 1100])
def test_wav2img_matches_jax_resize(T):
    x = np.random.RandomState(T).randn(2, T, 64).astype(np.float32)
    want = np.asarray(JH.HtsatEncoder()._wav2img(jnp.asarray(x)))
    got = TH.HtsatEncoder(embed_dim=8, depths=(1, 1, 1, 1),
                          num_heads=(1, 1, 1, 1)).wav2img(
        torch.from_numpy(x))
    got = got.permute(0, 2, 3, 1).numpy()                 # NCHW -> NHWC
    assert got.shape == want.shape == (2, 256, 256, 1)
    if T >= 1024:
        np.testing.assert_array_equal(got, want)
    else:
        close(got, want, 1e-5, f"wav2img T={T}")
    # the reason for the matrix: torch's bicubic is another kernel
    if T == 1001:
        bicubic = F.interpolate(torch.from_numpy(x)[:, None], (1024, 64),
                                mode="bicubic", align_corners=False)[:, 0]
        resized = torch.einsum("btf,ti->bif", torch.from_numpy(x),
                               torch.from_numpy(TH.cubic_resize_matrix(
                                   T, 1024)))
        assert float((bicubic - resized).abs().max()) > 0.05


def encoder_pair(size, seed=0):
    kw = SMALL[size]
    jmod = JH.HtsatEncoder(**kw)
    T = kw["spec_size"] * kw["spec_size"] // 64 - 23
    x = np.random.RandomState(seed).randn(2, T, 64).astype(np.float32)
    n = np.asarray([T, T // 2 + 3])
    v = random_variables(jmod, jnp.asarray(x), jnp.asarray(n), seed=seed)
    port = TH.HtsatEncoder(**kw)
    port.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in
                          htsat_state_dict_from_jax(
                              v["params"], v["batch_stats"]).items()})
    return jmod, v, port.eval(), x, n


@pytest.mark.parametrize("size", [256, 128])
def test_encoder_matches_jax(size):
    jmod, v, port, x, n = encoder_pair(size)
    want = jax.device_get(jax.jit(jmod.apply)(v, jnp.asarray(x),
                                              jnp.asarray(n)))
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(n))
    for k in ("attn_emb", "fc_emb"):
        close(got[k].numpy(), want[k], what=f"spec {size} {k}")
    np.testing.assert_array_equal(got["attn_emb_len"].numpy(),
                                  want["attn_emb_len"])
    assert got["attn_emb"].shape[1] == size * size // 2048   # 32, 8
    assert got["attn_emb"].shape[-1] == port.fc_emb_size == jmod.fc_emb_size
    assert sum(np.size(a) for a in jax.tree_util.tree_leaves(
        v["params"])) == sum(p.numel() for p in port.parameters())


def test_constant_tables_are_built_once():
    """The resize matrix and the shifted-window masks are made once per
    shape and device (``layers.device_table``): a second forward at the
    same shapes builds no table, so on the card it copies nothing from
    host memory."""
    _, _, port, x, n = encoder_pair(128)
    args = (torch.from_numpy(x), torch.from_numpy(n))
    device_table.cache_clear()
    with torch.no_grad():
        port(*args)
        first = device_table.cache_info()
        port(*args)
        second = device_table.cache_info()
    # the resize (233 -> 512 frames) and the masks of the two stages
    # whose grid holds more than one window
    assert first.misses == 3 and first.hits == 0
    assert second.misses == 3 and second.hits == 3


def test_weight_round_trip_is_exact():
    """HTSAT_Swin_Transformer keys at the published depths (2, 2, 6, 2)
    -> JAX converter -> the port's inverse: the same arrays."""
    port = TH.HtsatEncoder()
    rng = np.random.RandomState(3)
    sd = {k: (rng.rand(*t.shape) + 0.5 if k.endswith("running_var")
              else rng.randn(*t.shape)).astype(np.float32)
          for k, t in port.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    params, stats = JH.convert_htsat(sd)
    back = {k: a for k, a in htsat_state_dict_from_jax(params, stats).items()
            if not k.endswith("num_batches_tracked")}
    assert set(back) == set(sd)
    for k, a in sd.items():
        np.testing.assert_array_equal(back[k], a, err_msg=k)


# ------------------------------------------------- the captioner --

def captioner_pair(kw, seed=0, b=None):
    """A JAX captioner (the small HTS-AT ``kw``, a 1-layer decoder at emb
    32, 2 heads) and the port's on the same weights."""
    return item8_captioner_pair(JH.HtsatEncoder(**kw), TH.HtsatEncoder(**kw),
                                J_MEL, CNN14_MEL_32K, seed=seed, b=b)


def test_greedy_caption_matches_jax():
    jmodel, v, port, b = captioner_pair(SMALL[128], seed=4)
    want = jax.device_get(jax.jit(lambda v_, w, n: j_generate(
        jmodel, v_, w, n, max_length=12))(
            v, jnp.asarray(b["wav"]), jnp.asarray(b["wav_len"]
                                                   .astype(np.int32))))
    got = generate(port, torch.from_numpy(b["wav"]),
                   torch.from_numpy(b["wav_len"]), max_length=12)
    np.testing.assert_array_equal(got["seq"].numpy(), np.asarray(want["seq"]))
    assert len(np.unique(want["seq"])) > 3


@pytest.fixture(scope="module")
def xe_step():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        return xe_step_of(*captioner_pair(SMALL[128], seed=2)[:3],
                          clips(seed=5, B=3, Lc=8))
    finally:
        torch.set_num_threads(threads)


def test_xe_step_matches_jax(xe_step):
    check_xe_step(xe_step)
    # the Swin stages and their relative position tables learned
    moved = {k for k, p in xe_step["params"].items()
             if "relative_position_bias_table" in k}
    assert moved and all(np.abs(xe_step["mu"][k]).max() > 0 for k in moved)
