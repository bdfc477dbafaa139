"""The port's serving export (``eval/export.py``) against the live port and
the JAX package's export, on the CPU.

The four kernels as registered operators pass ``torch.library.opcheck``.
The generator artifact (``fc``, ``cnn_blstm``, ``bgru``; the widths of
``tests/test_export.py``: label dim 7, hidden 16, ``blstm_size`` 8, f32)
equals the port's live model under bucket-bound padding bit for bit, and
JAX's own ``ExportedGenerator`` built from the same weights within 1e-5
(``tests/test_export.py``'s tolerance); its batch-4 artifact equals the
batch-1 artifact row by row within 1e-5 (mixed lengths, zero-length surplus
rows; the rows' GEMMs run over another batch size). The synthesis artifact
(PML closed loop, WORLD with the bap voicing rule on a soft track,
Griffin-Lim; ``VocoderConfig(spec_size=17, nm_size=9)`` / ``mel_size=20``,
100 frames under a 128 bound) equals the port's ``synthesize`` bit for bit,
and holds against the JAX package's ``synthesize`` with the JAX noise
injected at the tolerances of ``tests/test_torch_{vocoder,world,melspec}.py``:
PML and WORLD 1e-2 of the RMS in RMS and 5e-2 of the largest sample;
Griffin-Lim's 64 iterations by re-analysis (0.05 nats on average, mel-MCD
against the source within 0.1 dB of JAX's). The features are the port's
analysis of the voiced/unvoiced test signal, so no voicing decision sits on
a threshold.

A PML or WORLD synthesis artifact holds the closed loop's ~7,000 operator
nodes, which ``torch.export`` traces, saves and loads in 44–48 s on the
CPU: each vocoder's is made once, by a module fixture.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percivaltts_tpu.config import ModelConfig as JaxModelConfig
from percivaltts_tpu.config import VocoderConfig as JaxVocoderConfig
from percivaltts_tpu.data.normalize import NormStats as JaxNormStats
from percivaltts_tpu.eval import export as jax_export
from percivaltts_tpu.models import build_generator as jax_build_generator
from percivaltts_tpu.vocoders import get_vocoder as jax_get_vocoder
from percivaltts_tpu_torch import weights
from percivaltts_tpu_torch.config import ModelConfig, VocoderConfig
from percivaltts_tpu_torch.data.normalize import NormStats
from percivaltts_tpu_torch.eval.export import (
    ExportedGenerator,
    ExportedSynthesizer,
    export_generator,
    export_synthesis,
    write_export,
)
from percivaltts_tpu_torch.eval.measures import per_frame_mcd_np
from percivaltts_tpu_torch.models import build_generator
from percivaltts_tpu_torch.ops import frames_cuda, gru_cuda, lstm_cuda
from percivaltts_tpu_torch.vocoders import get_vocoder
from test_torch_dsp import voiced_unvoiced_signal
from test_torch_vocoder import jax_noise

LABEL_DIM, FEAT = 7, 15
GEN_VOC = dict(spec_size=9, nm_size=5)


# --- the kernels as operators -------------------------------------------------


def _r(rng, *shape):
    return torch.from_numpy(rng.normal(size=shape).astype(np.float32))


def _op_cases():
    rng = np.random.default_rng(0)
    T, B, H = 5, 3, 8
    lstm = (_r(rng, T, B, 4 * H), _r(rng, T, B, 4 * H), _r(rng, H, 4 * H), _r(rng, H, 4 * H))
    gru = (_r(rng, T, B, 3 * H), _r(rng, T, B, 3 * H), _r(rng, H, 3 * H), _r(rng, H, 3 * H),
           _r(rng, H), _r(rng, H))
    x, frames = _r(rng, 2, 1000), _r(rng, 2, 13, 400)
    Hw = 264  # a width of the "wide" route (H > 256): a cluster of blocks a direction
    wide = (_r(rng, 3, 2, 4 * Hw), _r(rng, 3, 2, 4 * Hw), _r(rng, Hw, 4 * Hw), _r(rng, Hw, 4 * Hw))
    return {
        "bilstm_fwd": ("bilstm_fwd", (*lstm, False)),
        "bilstm_fwd cells": ("bilstm_fwd", (*lstm, True)),
        "bilstm_fwd wide": ("bilstm_fwd", (*wide, True)),
        "bigru_fwd": ("bigru_fwd", gru),
        "frame_window": ("frame_window", (x, 400, 80, _r(rng, 400))),
        "frame_window no window": ("frame_window", (x, 400, 80, None)),
        "overlap_add": ("overlap_add", (frames, 80, 1000)),
        "overlap_add stride 0": ("overlap_add", (_r(rng, 400).expand(1, 13, 400), 80, 1000)),
    }


@pytest.mark.parametrize("case", sorted(_op_cases()))
def test_operators_pass_opcheck(case):
    """Schema, fake kernel (shapes, dtypes, strides against the CPU kernel,
    also under symbolic shapes) and autograd registration of each op."""
    name, args = _op_cases()[case]
    op = getattr(torch.ops.percival, name).default
    torch.library.opcheck(op, args)


def test_wrappers_equal_the_operators_and_the_twins():
    """On CPU tensors the eager wrappers, the operators (as an exported graph
    calls them) and the twins agree bit for bit, and nothing counts a
    launch."""
    cases = _op_cases()
    pairs = [
        (lstm_cuda.bilstm_fwd, lstm_cuda.bilstm_fwd_reference, "bilstm_fwd cells"),
        (gru_cuda.bigru_fwd, gru_cuda.bigru_fwd_reference, "bigru_fwd"),
        (frames_cuda.frame_window, frames_cuda.frame_window_reference, "frame_window"),
        (frames_cuda.overlap_add, frames_cuda.overlap_add_reference, "overlap_add stride 0"),
    ]
    for wrapper, twin, case in pairs:
        name, args = cases[case]
        outs = [wrapper(*args), getattr(torch.ops.percival, name)(*args), twin(*args)]
        outs = [o if isinstance(o, (tuple, list)) else (o,) for o in outs]
        assert len({len(o) for o in outs}) == 1
        for got in outs[:2]:
            for g, w in zip(got, outs[2]):
                assert torch.equal(g, w)
        assert wrapper.launches == 0


# --- the generator artifact ---------------------------------------------------


def _stats(dim):
    rng = np.random.default_rng(dim)
    return (rng.normal(size=dim).astype(np.float32),
            (1.0 + rng.uniform(size=dim)).astype(np.float32))


def _generators(kind):
    """The JAX generator and its parameters, and the port's holding them."""
    kw = dict(generator=kind, hidden_size=16, num_layers=1, cnn_blocks=1, blstm_size=8,
              compute_dtype="float32")
    jg = jax_build_generator(JaxModelConfig(**kw), JaxVocoderConfig(**GEN_VOC), LABEL_DIM)
    params = jg.init(jax.random.key(0), jnp.zeros((1, 64, LABEL_DIM), jnp.float32))
    tg = build_generator(ModelConfig(**kw), VocoderConfig(**GEN_VOC), LABEL_DIM)
    weights.load_flax_params(tg, jax.tree.map(np.asarray, params))
    return jg, params, tg


@pytest.mark.parametrize("kind", ["fc", "cnn_blstm", "bgru"])
def test_exported_generator_equals_live_and_jax(tmp_path, kind):
    jg, params, tg = _generators(kind)
    ins, outs = _stats(LABEL_DIM), _stats(FEAT)
    d = str(tmp_path / "torch")
    write_export(d, export_generator(tg, NormStats(*ins), NormStats(*outs), LABEL_DIM, (32, 64)),
                 LABEL_DIM, FEAT, {"kind": "pml"})
    ex = ExportedGenerator(d, device="cpu")
    assert ex.bounds == [32, 64] and ex.batch == 1
    assert sorted(os.listdir(d)) == ["gen_t32.pt2", "gen_t64.pt2", "manifest.json"]

    rng = np.random.default_rng(0)
    lab = rng.normal(size=(50, LABEL_DIM)).astype(np.float32)
    got = ex(lab)
    # the live model under the same (bucket-bound) padding, normalized on the host
    padded = np.zeros((1, 64, LABEL_DIM), np.float32)
    padded[0, :50] = NormStats(*ins).normalize(lab)
    with torch.inference_mode():
        live = tg(torch.from_numpy(padded)).numpy()[0, :50]
    assert got.shape == (50, FEAT) and got.dtype == np.float32
    assert np.array_equal(got, NormStats(*outs).denormalize(live))

    jd = str(tmp_path / "jax")
    jax_export.write_export(
        jd, jax_export.export_generator(jg.apply, params, JaxNormStats(*ins), JaxNormStats(*outs),
                                        LABEL_DIM, (64,)),
        LABEL_DIM, FEAT, {"kind": "pml"})
    np.testing.assert_allclose(got, jax_export.ExportedGenerator(jd)(lab), atol=1e-5)

    with pytest.raises(ValueError, match="largest exported bound is 64"):
        ex(np.zeros((65, LABEL_DIM), np.float32))


@pytest.mark.parametrize("kind", ["fc", "cnn_blstm", "bgru"])
def test_batched_artifact_matches_batch_one(tmp_path, kind):
    """Five utterances at bound 64 in calls of 4: mixed lengths in one call,
    three zero-length surplus rows in the second."""
    _, _, tg = _generators(kind)
    ins, outs = NormStats(*_stats(LABEL_DIM)), NormStats(*_stats(FEAT))
    d1, d4 = str(tmp_path / "b1"), str(tmp_path / "b4")
    write_export(d1, export_generator(tg, ins, outs, LABEL_DIM, (64,)), LABEL_DIM, FEAT,
                 {"kind": "pml"})
    write_export(d4, export_generator(tg, ins, outs, LABEL_DIM, (64,), batch=4), LABEL_DIM, FEAT,
                 {"kind": "pml"}, batch=4)
    ex1, ex4 = ExportedGenerator(d1, device="cpu"), ExportedGenerator(d4, device="cpu")
    assert ex4.batch == 4
    rng = np.random.default_rng(1)
    labs = [rng.normal(size=(n, LABEL_DIM)).astype(np.float32) for n in (50, 30, 64, 17, 41)]
    assert [len(g) for _, g in ex4.groups(labs)] == [4, 1]
    want = [ex1(lab) for lab in labs]
    got = ex4.predict_batch(labs)
    for w, g, lab in zip(want, got, labs):
        assert g.shape == (lab.shape[0], FEAT)
        np.testing.assert_allclose(g, w, atol=1e-5)
    np.testing.assert_allclose(ex4(labs[0]), want[0], atol=1e-5)


# --- the synthesis artifact ---------------------------------------------------

SYN_CASES = {
    "pml": dict(spec_size=17, nm_size=9),
    "world": dict(kind="world", spec_size=17, nm_size=9, vuv_rule="bap"),
    "melspec": dict(kind="melspec", mel_size=20),
}
T = 100  # under the 128-frame bound: the in-graph pad tail runs


def _features(voc):
    """100 frames of the port's analysis of the voiced/unvoiced signal (both
    voicing transitions inside); WORLD's vuv channel replaced by a soft
    track, which the bap rule decides on."""
    feats = voc.analyze(voiced_unvoiced_signal(2))[20 : 20 + T]
    if voc.kind == "world":
        feats = feats.copy()
        feats[:, 1] = np.clip(0.5 + 0.4 * np.sin(np.arange(T) / 7.0), 0.06, 0.94)
    return feats


@pytest.fixture(scope="module", params=sorted(SYN_CASES))
def synthesis(request, tmp_path_factory):
    """One exported, saved and reloaded synthesis artifact per vocoder,
    drawn with the JAX package's noise (``_noise`` replaced while it is
    exported and while the port synthesizes), and what it renders."""
    kind = request.param
    voc = get_vocoder(VocoderConfig(fs=16000, **SYN_CASES[kind]), device="cpu")
    feats = _features(voc)
    mp = pytest.MonkeyPatch()
    mp.setattr(type(voc), "_noise",
               lambda self, n, seed, device: torch.from_numpy(jax_noise(n, seed)))
    try:
        arts = export_synthesis(voc, (T,))
        d = str(tmp_path_factory.mktemp(kind) / "export")
        write_export(d, {}, 1, voc.feature_size, dataclasses.asdict(voc.cfg),
                     syn_artifacts=arts, hop=voc.cfg.shift_samples)
        syn = ExportedSynthesizer(d, device="cpu")
        wav = syn(feats)
        port = voc.synthesize(feats, seed=0)
    finally:
        mp.undo()
    return kind, voc, feats, sorted(arts), d, syn, wav, port


def test_exported_synthesizer_equals_the_port(synthesis):
    kind, voc, feats, bounds, d, syn, wav, port = synthesis
    assert bounds == syn.bounds == [128]  # the bound rounds up to the frame multiple
    assert sorted(os.listdir(d)) == ["manifest.json", "syn_t128.pt2"]
    assert wav.shape == port.shape == (T * 80,) and wav.dtype == np.float32
    assert np.array_equal(wav, port), f"{kind}: max diff {np.abs(wav - port).max()}"
    with pytest.raises(ValueError, match="largest exported synthesis bound is 128"):
        syn(np.zeros((129, voc.feature_size), np.float32))
    assert syn(feats[:0]).shape == (0,)


def test_exported_synthesizer_matches_jax(synthesis):
    kind, voc, feats, *_, wav, _ = synthesis
    want = jax_get_vocoder(JaxVocoderConfig(fs=16000, **SYN_CASES[kind])).synthesize(feats, seed=0)
    assert want.shape == wav.shape
    if kind == "melspec":
        re = voc.analyze_batch([wav, want])
        assert np.mean(np.abs(re[0] - re[1])) <= 0.05
        src = voc.cepstra(feats)
        mcd = [float(np.mean(per_frame_mcd_np(voc.cepstra(r), src))) for r in re]
        assert abs(mcd[0] - mcd[1]) <= 0.1, mcd
        return
    assert np.sqrt(np.mean((wav - want) ** 2)) <= 1e-2 * np.sqrt(np.mean(want**2))
    np.testing.assert_allclose(wav, want, atol=5e-2 * np.abs(want).max())
