"""The port's ESResNeXt-FBSP (``models/resnext.py``) against the JAX
package's, on the CPU.  JAX variables are drawn from a numpy seed on
flax's shapes (``test_torch_item8_wiring.random_variables``; the FBSP
filterbank's order m in [0.5, 1.5], bandwidth fb in [0.5, 2] and centres
arange(F) + N(0, 0.3^2)) and carried across by
``models.convert.esresnext_state_dict_from_jax``.  The JAX trunk's depth
is fixed in ``ESResNeXtFBSP.setup``; a subclass here (``SmallFBSP``)
builds it with one block a stage, as the port's ``layers`` does.

  * the signal helpers against JAX: ``scale_value_range``,
    ``frame_signal`` (a clip shorter than a frame, and the centred
    padding of the last frame), ``stft_realimag`` within 1e-5 relative
    (and against ``torch.stft`` within 1e-4),
    ``resize_bilinear_align_corners`` within 1e-5 relative (and against
    ``F.interpolate(align_corners=True)`` within 1e-4);
  * ``LinearFBSP``'s filters and spectrogram (normalised and not) and the
    dB image at the public AudioSet settings (n_fft 2048, hop 561, window
    1654 blackmanharris, normalised; 224 x 224) of 1 s clips, held
    against the float64 evaluation of the same function (the port run in
    float64 on the same float32 parameters): the filters are cosines and
    sines of fc * t, arguments up to pi * n_fft / 2, and XLA's float32
    sin / cos on the CPU lose accuracy in proportion to the argument
    (JAX's filters lie ~3x further from float64 than the port's: 2.9e-6
    against 1.1e-6 at n_fft 256), so the bar is that the port is no
    further from float64 than JAX is, and JAX within 1e-4 relative (the
    dB image: 1e-2 dB) of it; ``fbsp_norm_loss`` within 1e-5 relative;
  * the encoder (``ESResNeXtFBSPEncoder``, one block a stage, a 64 x 64
    image) on a padded batch: the clip that fills its length within 1e-4
    relative in ``attn_emb`` and ``fc_emb``; ``attn_emb_len`` equal (W /
    32 for every clip); the classifier's logits (with ``att5`` and
    ``fc``) within 1e-4 relative.  A zero-padded clip is ill-conditioned
    in both packages: the encoder scales the wave by 32767 into the
    int16 range and the frontend maps that back to [-1, 1], so digital
    silence becomes the constant 1.5e-5, whose filter responses cancel
    down to float32 rounding noise (powers near 1e-21, -200 dB, JAX and
    the port 20 dB apart there, the float64 evaluation between them);
    the padded clip is held by the float64 floor above (the port no
    further from float64 than JAX) and by no bound against JAX: its
    ``attn_emb`` (scale 6.23) lies 2.09 from JAX's, JAX's 1.85 and the
    port's 0.965 from float64; its ``fc_emb`` (scale 4.55) 0.841 from
    JAX's, 0.739 and 0.457 from float64 (30% of the scale, where the
    filled clip agrees within 3.7e-5); the captioner tests use clips
    that fill their length;
  * one XE step of that encoder + a 1-layer ``TransformerDecoder``
    captioner (``input_mode="raw_wav"``, dropout the identity), against
    JAX's ``make_train_step``: the loss within 1e-5 relative (and of the
    port's own step in float64); the parameters after Adam within 1e-5
    and the BN statistics within 1e-5 relative, each element held
    against JAX's wherever JAX's float32 step lies within that bound of
    the float64 step, and against the float64 step where it does not
    (:func:`held_against_jax`); the raw gradient norm within 1e-3 of the
    float64 step's and nearer to it than JAX's.  Not the gradients
    themselves: in float32 this model's trunk gradients are
    ill-conditioned in both packages (train-mode BN over a 2 x 2 map of
    3 clips, each block's gradient a small residual after BN's
    projection): the port's float32 Adam moments lie up to 5% from its
    float64 ones (``layer1``), JAX's further (7% in ``layer1.0.conv3``;
    16% and 31% at a 224 x 224 image), and the global clip carries
    JAX's norm error (7.5e-4 from float64; the port's 1.6e-4) into
    every other gradient.  The first Adam step moves a parameter by
    about lr * sign(g), so the parameters agree except where g is near
    0 and its float32 error flips the step: JAX's float32 step misses
    the float64 step by over 1e-5 in 33655 of 10238851 parameters
    (0.33%, each miss under 5.4e-5), the port's in 116; the port misses
    JAX in 106 of the elements where JAX is within the bound (1.0e-5
    of all), and JAX's own misses are the port's against JAX
    (33656 in all), so a plain bound of 0.1% against JAX cannot hold;
    the BN statistics (forward quantities of the FBSP filters, whose
    float32 sin / cos differ as above): JAX off float64 in 19 of 30848,
    the port off JAX in 3 of the rest;
  * a float32 greedy caption of that captioner token-exact against JAX;
  * the weight round trip at the published structure (ResNeXt-50,
    attention, FBSP): a seeded dict under the reference keys -> JAX
    ``convert_esresnext`` -> the port's inverse gives back the same
    arrays."""

import copy

import numpy as np
import pytest
import scipy.signal as sps
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from audiocaption_tpu.models import resnext as JR
from audiocaption_tpu.models.captioner import generate as j_generate
from audiocaption_tpu.ops.frontend import CNN14_MEL_32K as J_MEL

from audiocaption_tpu_torch.models import resnext as TR
from audiocaption_tpu_torch.models.captioner import generate
from audiocaption_tpu_torch.models.convert import (
    esresnext_state_dict_from_jax)
from audiocaption_tpu_torch.ops.frontend import CNN14_MEL_32K

from test_torch_family import clips
from test_torch_item8_wiring import (
    item8_captioner_pair, port_step_of, random_variables, xe_step_of)
from test_torch_panns import close
from test_torch_train_step import MISS_SHARE, PARAM_ATOL

torch.set_num_threads(2)
SMALL = dict(n_fft=256, hop_length=64, win_length=200,
             window="blackmanharris", normalized=True, spec_height=64,
             spec_width=64, num_classes=7, apply_attention=True)
PUBLIC = dict(n_fft=2048, hop_length=561, win_length=1654,
              window="blackmanharris", normalized=True)


class SmallFBSP(JR.ESResNeXtFBSP):
    """The JAX classifier with ``layers`` blocks a stage (its setup, the
    trunk's depth passed through)."""
    layers: tuple = (1, 1, 1, 1)

    def setup(self):
        self._win = sps.get_window(self.window, self._win_len,
                                   fftbins=True).astype(np.float32)
        self.fbsp = JR.LinearFBSP(out_features=self.n_fft // 2 + 1,
                                  normalized=self.normalized, name="fbsp")
        self.trunk = JR.ResNeXtTrunk(layers=self.layers,
                                     apply_attention=self.apply_attention,
                                     num_classes=self.num_classes,
                                     name="trunk")


def fbsp_params(F_, seed):
    rng = np.random.RandomState(seed)
    return {"m": rng.uniform(0.5, 1.5, F_).astype(np.float32),
            "fb": rng.uniform(0.5, 2.0, F_).astype(np.float32),
            "fc": (np.arange(F_) + 0.3 * rng.randn(F_)).astype(np.float32)}


def with_fbsp(v, seed, path=()):
    """``v`` with every ``fbsp`` subtree's m / fb / fc redrawn."""
    p = v["params"]
    for k in path:
        p = p[k]
    p["fbsp"] = fbsp_params(p["fbsp"]["m"].shape[0], seed)
    return v


def waves(n=2, seconds=1.0, sr=32000, seed=0):
    rng = np.random.RandomState(seed)
    t = np.arange(int(sr * seconds)) / sr
    return np.stack([0.3 * np.sin(2 * np.pi * 300 * (i + 1) * t)
                     + 0.05 * rng.randn(len(t)) for i in range(n)]
                    ).astype(np.float32)


# ------------------------------------------------------------ signal --

def test_signal_helpers_match_jax():
    x = waves(seed=1)
    np.testing.assert_allclose(
        TR.scale_value_range(torch.from_numpy(x), -1, 1, 0, 10).numpy(),
        np.asarray(JR.scale_value_range(jnp.asarray(x), -1, 1, 0, 10)),
        rtol=1e-6, atol=1e-6)
    win = sps.get_window("blackmanharris", 200, fftbins=True).astype(
        np.float32)
    for T in (150, 1000, 32000):
        got = TR.frame_signal(torch.from_numpy(x[:, :T]), 200, 64,
                              torch.from_numpy(win))
        want = JR.frame_signal(jnp.asarray(x[:, :T]), 200, 64, win)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-7)
    got = TR.stft_realimag(torch.from_numpy(x), 256, 64, 200, win, True)
    want = np.asarray(JR.stft_realimag(jnp.asarray(x), 256, 64, 200, win,
                                       True))
    close(got.numpy(), want, 1e-5, "stft_realimag")
    ref = torch.stft(torch.from_numpy(x), 256, 64, 200,
                     torch.from_numpy(win), center=True, pad_mode="reflect",
                     normalized=True, onesided=True, return_complex=True)
    close(got.numpy(), torch.view_as_real(ref).numpy(), 1e-4, "torch.stft")
    img = np.random.RandomState(2).rand(2, 3, 85, 497).astype(np.float32)
    got = TR.resize_bilinear_align_corners(torch.from_numpy(img), 224, 224)
    close(got.numpy(), np.asarray(JR.resize_bilinear_align_corners(
        jnp.asarray(img), 224, 224)), 1e-5, "resize")
    # torch's own kernel weighs in another float32 order
    close(got.numpy(), F.interpolate(torch.from_numpy(img), (224, 224),
                                     mode="bilinear",
                                     align_corners=True).numpy(),
          1e-4, "F.interpolate")


def held_against_jax(port, jax_, f64, atol, what, jax_off_limit=0.01):
    """Each element of the port's float32 step within ``atol`` (a number,
    or a function of JAX's array) of JAX's wherever JAX's float32 step is
    within ``atol`` of the float64 step, and of the float64 step where
    JAX's is not; MISS_SHARE of all elements may miss either way, and JAX
    may lie off float64 in at most ``jax_off_limit`` of them."""
    n = off = miss_jax = miss_f64 = 0
    for k, w in jax_.items():
        tol = atol(w) if callable(atol) else atol
        jax_off = np.abs(w - f64[k]) > tol
        n += w.size
        off += int(jax_off.sum())
        miss_jax += int((~jax_off & (np.abs(port[k] - w) > tol)).sum())
        miss_f64 += int((jax_off & (np.abs(port[k] - f64[k]) > tol)).sum())
    print(f"{what}: JAX off float64 in {off}/{n}; the port off JAX where "
          f"JAX is on it in {miss_jax}, off float64 where JAX is not in "
          f"{miss_f64}")
    assert off <= jax_off_limit * n, (what, off, n)
    assert miss_jax + miss_f64 <= MISS_SHARE * n, (what, miss_jax, miss_f64)


def floor64(name, port, jax_out, f64, logic_tol):
    """The port's float32 result no further from the float64 evaluation of
    the same function (the port run in float64 on the same float32
    parameters) than JAX's float32 result is, and JAX within
    ``logic_tol`` of it (the same function)."""
    p, j, r = (np.asarray(a, np.float64) for a in (port, jax_out, f64))
    assert p.shape == j.shape == r.shape, name
    e_port, e_jax = np.abs(p - r).max(), np.abs(j - r).max()
    print(f"{name}: port vs float64 {e_port:.3g}, JAX vs float64 "
          f"{e_jax:.3g}, port vs JAX {np.abs(p - j).max():.3g}")
    assert e_port <= e_jax and e_jax <= logic_tol, name


@pytest.mark.parametrize("normalized", [True, False])
def test_linear_fbsp_and_norm_loss_match_jax(normalized):
    frames = np.random.RandomState(3).randn(2, 9, 256).astype(np.float32)
    jmod = JR.LinearFBSP(out_features=129, normalized=normalized)
    v = {"params": fbsp_params(129, 4)}
    (spec, (wr, wi)) = jax.jit(jmod.apply)(v, jnp.asarray(frames))
    port = TR.LinearFBSP(129, normalized)
    port.load_state_dict({k: torch.from_numpy(a)
                          for k, a in v["params"].items()})
    with torch.no_grad():
        got, (tr_, ti_) = port(torch.from_numpy(frames))
        ref, (rr, ri) = port.double()(torch.from_numpy(frames).double())
    scale = float(np.abs(rr.numpy()).max())
    floor64("W_re", tr_, wr, rr, 1e-4 * scale)
    floor64("W_im", ti_, wi, ri, 1e-4 * scale)
    floor64("spec", got, spec, ref, 1e-4 * float(ref.abs().max()))
    loss = float(JR.fbsp_norm_loss(wr, wi, 256, normalized))
    close(float(TR.fbsp_norm_loss(tr_, ti_, 256, normalized)), loss, 1e-5,
          "loss")
    close(float(TR.fbsp_norm_loss(rr, ri, 256, normalized)), loss, 1e-5,
          "loss f64")


def test_db_image_at_public_settings_matches_jax():
    jmod = JR.ESResNeXtFBSP(**PUBLIC)
    x = waves(seed=5) * 32767.0
    v = {"params": {"fbsp": fbsp_params(1025, 6)}}
    want, _ = jax.jit(lambda v_, w: jmod.apply(
        v_, w, method=JR.ESResNeXtFBSP.db_image))(v, jnp.asarray(x))
    port = TR.ESResNeXtFBSP(**PUBLIC)
    port.fbsp.load_state_dict({k: torch.from_numpy(a)
                               for k, a in v["params"]["fbsp"].items()})
    with torch.no_grad():
        got, _ = port.db_image(torch.from_numpy(x))
        ref, _ = port.double().db_image(torch.from_numpy(x).double())
    want = np.asarray(want).transpose(0, 3, 1, 2)         # NHWC -> NCHW
    assert got.shape == want.shape == (2, 3, 224, 224)
    floor64("dB image", got, want, ref, 1e-2)


# ----------------------------------------------------------- encoder --

def encoder_variables(jenc, wav, n, seed):
    v = random_variables(jenc, jnp.asarray(wav), jnp.asarray(n), seed=seed)
    return with_fbsp(v, seed + 1, ("fbsp_model",))


def test_encoder_and_classifier_match_jax():
    jenc = JR.ESResNeXtFBSPEncoder(fbsp_model=SmallFBSP(**SMALL))
    wav = waves(seed=7)
    n = np.asarray([32000, 20000])
    wav[1, 20000:] = 0.0
    v = encoder_variables(jenc, wav, n, 8)
    port = TR.ESResNeXtFBSPEncoder(TR.ESResNeXtFBSP(
        **SMALL, layers=(1, 1, 1, 1), classifier=False))
    port.load_state_dict({"fbsp_model." + k: torch.from_numpy(np.array(a))
                          for k, a in esresnext_state_dict_from_jax(
                              v["params"]["fbsp_model"],
                              v["batch_stats"]["fbsp_model"]).items()})
    want = jax.device_get(jax.jit(jenc.apply)(v, jnp.asarray(wav),
                                              jnp.asarray(n)))
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(wav), torch.from_numpy(n))
        ref = port.double()(torch.from_numpy(wav).double(),
                            torch.from_numpy(n))
    port.float()
    for k in ("attn_emb", "fc_emb"):
        # the clip that fills its length, as any float32 output
        close(got[k][0].numpy(), want[k][0], what=k)
        # the padded one: its silence is a constant 1.5e-5 after the
        # int16 rescale, whose filter responses cancel to float32 noise
        floor64(f"padded clip {k}", got[k][1], want[k][1], ref[k][1],
                np.inf)
    np.testing.assert_array_equal(got["attn_emb_len"].numpy(),
                                  want["attn_emb_len"])
    assert got["attn_emb"].shape == (2, 2, 2048)
    assert sum(np.size(a) for a in jax.tree_util.tree_leaves(
        v["params"])) == sum(p.numel() for p in port.parameters())

    # the classifier, att5 and fc too, on the clip that fills its length
    jclf = SmallFBSP(**SMALL)
    x = wav[:1] * 32767.0
    vc = with_fbsp(random_variables(jclf, jnp.asarray(x), seed=9), 10)
    clf = TR.ESResNeXtFBSP(**SMALL, layers=(1, 1, 1, 1))
    clf.load_state_dict({k: torch.from_numpy(np.array(a)) for k, a in
                         esresnext_state_dict_from_jax(
                             vc["params"], vc["batch_stats"]).items()})
    with torch.no_grad():
        logits = clf.eval()(torch.from_numpy(x))
    close(logits.numpy(), np.asarray(jax.jit(jclf.apply)(
        vc, jnp.asarray(x))), what="logits")


def test_weight_round_trip_is_exact():
    """Reference ESResNeXt keys (ResNeXt-50, attention, FBSP) -> JAX
    converter -> the port's inverse: the same arrays."""
    port = TR.ESResNeXtFBSP(**PUBLIC, num_classes=527, apply_attention=True)
    rng = np.random.RandomState(11)
    sd = {k: (rng.rand(*t.shape) + 0.5 if k.endswith("running_var")
              else rng.randn(*t.shape)).astype(np.float32)
          for k, t in port.state_dict().items()
          if not k.endswith("num_batches_tracked")}
    params, stats = JR.convert_esresnext(sd)
    back = {k: a for k, a in esresnext_state_dict_from_jax(
        params, stats).items() if not k.endswith("num_batches_tracked")}
    assert set(back) == set(sd)
    for k, a in sd.items():
        np.testing.assert_array_equal(back[k], a, err_msg=k)


# --------------------------------------------------------- captioner --

def full_clips(seed):
    """``test_torch_family.clips`` whose clips all fill the batch's 1 s
    (no digital silence: see the module docstring)."""
    b = clips(seed=seed, B=3, Lc=8)
    b["wav"] = waves(3, seed=seed)
    b["wav_len"] = np.full(3, b["wav"].shape[1], np.int64)
    return b


def captioner_pair(seed, b=None):
    b = b or full_clips(seed)
    jmodel, v, port, b = item8_captioner_pair(
        JR.ESResNeXtFBSPEncoder(fbsp_model=SmallFBSP(**SMALL)),
        TR.ESResNeXtFBSPEncoder(TR.ESResNeXtFBSP(
            **SMALL, layers=(1, 1, 1, 1), classifier=False)),
        J_MEL, CNN14_MEL_32K, input_mode="raw_wav", seed=seed, b=b,
        prepare=lambda v_: with_fbsp(v_, seed + 1,
                                     ("encoder", "fbsp_model")))
    return jmodel, v, port, b


def test_greedy_caption_matches_jax():
    jmodel, v, port, b = captioner_pair(12)
    want = jax.device_get(jax.jit(lambda v_, w, n: j_generate(
        jmodel, v_, w, n, max_length=12))(
            v, jnp.asarray(b["wav"]), jnp.asarray(b["wav_len"]
                                                   .astype(np.int32))))
    got = generate(port, torch.from_numpy(b["wav"]),
                   torch.from_numpy(b["wav_len"]), max_length=12)
    np.testing.assert_array_equal(got["seq"].numpy(), np.asarray(want["seq"]))
    assert len(np.unique(want["seq"])) > 3


def test_xe_step_matches_jax_and_float64():
    jmodel, jvars, port, _ = captioner_pair(13)
    b = full_clips(14)
    port64 = copy.deepcopy(port).double()
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        s = xe_step_of(jmodel, jvars, port, b)
        s64 = port_step_of(port64, b, torch.float64)
    finally:
        torch.set_num_threads(threads)
    assert not s["m"]["skipped"] and not bool(s["j"]["skipped"])
    loss, loss64 = float(s["m"]["loss"]), float(s64["m"]["loss"])
    np.testing.assert_allclose(loss, float(s["j"]["loss"]), rtol=1e-5)
    np.testing.assert_allclose(loss, loss64, rtol=1e-5)
    norm, norm64 = float(s["m"]["grad_norm"]), float(s64["m"]["grad_norm"])
    j_norm = float(s["j"]["grad_norm"])
    print(f"ESResNeXt XE step raw gradient norm: port {norm}, float64 "
          f"{norm64}, JAX {j_norm}")
    np.testing.assert_allclose(norm, norm64, rtol=1e-3)
    assert abs(norm - norm64) <= abs(j_norm - norm64)
    held_against_jax(s["params"], s["j_params"], s64["params"], PARAM_ATOL,
                     "parameters")
    assert s["stats"] and set(s["stats"]) <= set(s["j_stats"])
    held_against_jax(s["stats"], {k: s["j_stats"][k] for k in s["stats"]},
                     s64["stats"],
                     lambda w: PARAM_ATOL * max(1.0, np.abs(w).max()),
                     "BN stats")
    assert all(np.abs(s["mu"][f"encoder.fbsp_model.fbsp.{k}"]).max() > 0
               for k in ("m", "fb", "fc"))
