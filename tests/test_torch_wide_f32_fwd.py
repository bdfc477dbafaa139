"""The f32 cluster forwards (route ``"wide_f32"``) on the CPU.

``csrc/{bilstm,bigru}_fwd_wide_f32.cu`` run on the card only; what surrounds
them is replayed here in torch (``ops/wide_f32_layout.py``): the forward's
plan of rows, chunks in shared memory and in registers, bytes and waves
(held against the launchers' own plan on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``), the widths the route
takes, a forward with its product summed in the kernels' order against the
plain twins and the Pallas kernels in interpret mode, the zero-padding of
widths that are not a multiple of 32, and the launchers' refusals.

Tolerances: the replayed forward within 1e-6·max(1, max|v|) of the twins
(f32, the same math with the product summed in another order over T = 5
steps); within 1e-5·max(1, max|v|) of the Pallas kernels (f32, XLA's sums in
another order, as the BPTT's test holds them); the plan and the padding
exactly.
"""

import torch_threads  # noqa: F401  (first: caps torch's threads per xdist worker)

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from percivaltts_tpu.ops import lstm_pallas
from percivaltts_tpu_torch import _build
from percivaltts_tpu_torch.ops import gru_cuda, lstm_cuda, wide_layout
from percivaltts_tpu_torch.ops import wide_f32_layout as wf
from percivaltts_tpu_torch.ops.gru_cuda import bigru_fwd_reference
from percivaltts_tpu_torch.ops.lstm_cuda import at_width, bilstm_fwd_reference
from percivaltts_tpu_torch.ops.mma_layout import bwd_route, fwd_route

GATES = {"lstm": 4, "gru": 3}
H100_CLUSTERS = 7  # clusters of 16 blocks the H100 holds at once (chip_smoke.py phase 13)
LOW = {"lstm": 256, "gru": 320}  # the one-block widths below the route


def _inputs(cell, T, B, H, seed):
    """numpy-seeded f32 forward inputs of ``cell`` in the twins' order: gx,
    W_h (and b_hn) per direction."""
    rng = np.random.default_rng(seed)
    gates = GATES[cell]
    a = lambda *s, sc=1.0: torch.from_numpy((rng.normal(size=s) * sc).astype(np.float32))  # noqa: E731
    args = (a(T, B, gates * H), a(T, B, gates * H), a(H, gates * H, sc=H ** -0.5),
            a(H, gates * H, sc=H ** -0.5))
    return args if cell == "lstm" else (*args, a(H, sc=0.1), a(H, sc=0.1))


def _twin(cell, *args):
    if cell == "lstm":
        return bilstm_fwd_reference(*args, with_cells=True)
    return bigru_fwd_reference(*args)


def _replay(cell, *args):
    if cell == "lstm":
        return wf.replay_fwd(cell, *args, with_cells=True)
    return wf.replay_fwd(cell, *args)


def _close(got, want, tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(np.asarray(g), w, rtol=0, atol=tol * max(1.0, np.abs(w).max()))


# --- the plan ------------------------------------------------------------------------------


# the plan at H = 512 on the H100's 7 clusters: (R, waves, chunks in shared
# memory, chunks in registers) by cell and B
PLANS_AT_512 = {("lstm", 1): (4, 1, 6, 2), ("lstm", 8): (4, 1, 6, 2), ("lstm", 32): (4, 3, 6, 2),
                ("lstm", 160): (8, 6, 5, 3), ("gru", 1): (4, 1, 8, 0), ("gru", 8): (4, 1, 8, 0),
                ("gru", 32): (8, 2, 7, 1), ("gru", 160): (8, 6, 7, 1)}


@pytest.mark.parametrize("cell,B", list(PLANS_AT_512))
def test_forward_plan_rows_chunks_and_bytes_at_h512(cell, B):
    """At H = 512 on the H100's 7 clusters of 16 blocks: B <= 8 on 4 rows a
    cluster in one wave, B = 160 on 8 rows in six, B = 32 on whichever of
    the two the step estimate puts lower (waves × ``fwd_step_ns``); at
    R = 8 the LSTM keeps 5 of its 8 chunks in shared memory and 3 in
    registers, the GRU 7 and 1, at R = 4 6 and 2, 8 and 0; each region of
    shared memory, the resident chunks as many as fit, within 232,448
    bytes; threads and registers a lane as the kernels take them."""
    gates = GATES[cell]
    r = wf.fwd_rows(B, 512, gates, H100_CLUSTERS)
    p = wide_layout.plan(512, gates)
    assert (r.R, r.waves, r.nres, r.nreg) == PLANS_AT_512[cell, B]
    parts = {"chunks": r.nres * wf.CHUNK * (p.NC + 4) * 4,
             "h": 2 * (512 // 4) * (r.R + 1) * 4 * 4, "partials": wf.FWD_GROUPS * r.R * p.NC * 4}
    assert sum(parts.values()) == r.smem == wf.fwd_smem_bytes(512, gates, r.nres, r.R)
    room = wf.SMEM_OPTIN - wf.FWD_STATIC_SMEM
    assert r.smem <= room < wf.fwd_smem_bytes(512, gates, r.nres + 1, r.R)
    costs = {R: -(-2 * -(-B // R) // H100_CLUSTERS) * wf.fwd_step_ns(512, gates, R)
             for R in wf.FWD_ROWS}
    assert costs[r.R] == min(costs.values())
    assert wf.fwd_threads(512, gates) == (256 if cell == "lstm" else 384)
    # W_h words a thread holds: 16 a chunk a column quad of its lane, at most 96
    assert r.nreg * 16 * wf.fwd_quads(p.NC) <= 96
    # at most one (row, unit) pair a thread in the gate phase
    assert r.R * p.Hb <= wf.fwd_threads(512, gates)


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_every_width_the_forward_route_takes_has_a_plan(cell):
    """f32 past the one-block widths (LSTM 256, GRU 320) up to 512: every
    width pads to a multiple of 32, has a forward plan at B = 1 and 160 with
    at most ``FWD_MAX_REG`` chunks in registers, and the forward takes
    ``"wide_f32"``; past 512 the CUDA-core cluster kernel's route; bf16 is
    not this route's."""
    gates = GATES[cell]
    assert wf.max_h(gates) == 512
    for H in range(LOW[cell] + 1, 513):
        Hp = wf.padded(H)
        p = wide_layout.plan(Hp, gates)
        for B in (1, 160):
            r = wf.fwd_rows(B, Hp, gates, H100_CLUSTERS)
            assert r.nres + r.nreg == len(wf.chunks(Hp)) and r.nreg <= wf.FWD_MAX_REG
            assert r.smem <= wf.SMEM_OPTIN and p.NC in (96, 128)
        assert fwd_route(torch.float32, H, cell) == "wide_f32", H
        assert fwd_route(torch.float32, H, cell, 160) == "wide_f32", H
    for H in (513, 544, 640, 1024, 4096):
        assert fwd_route(torch.float32, H, cell) == "wide"
        with pytest.raises(ValueError, match="no f32 cluster forward plan"):
            wf.fwd_rows(8, wf.padded(H), gates, H100_CLUSTERS)
    for H in (288, 352, 512):
        assert fwd_route(torch.bfloat16, H, cell) == "wide_mma"


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_bptt_keeps_its_measured_rows_behind_the_moved_forward(cell):
    """The f32 BPTT's route follows the measurements: the few batch rows it
    once kept on ``"wide"`` (B <= 8 up to H = 384, B <= 6 up to 416 / 512)
    now take ``"wide_f32"``, whose few-row plan the card measured faster
    there, so the BPTT takes ``"wide_f32"`` at every width up to H = 512
    (its route takes no batch); the forward takes ``"wide_f32"`` at all of
    them without a batch (with one, but at the rows of its own table)."""
    for H in range(LOW[cell] + 1, 513, 7):
        assert bwd_route(torch.float32, H, cell) == "wide_f32"
        assert fwd_route(torch.float32, H, cell) == "wide_f32"
        for B in (1, 2, 3, 4, 5, 6, 7, 8, 9, 16, 32, 160):
            assert fwd_route(torch.float32, H, cell, B) in ("wide", "wide_f32")
    for h, b in {"lstm": ((384, 8), (416, 6)), "gru": ((384, 8), (512, 6))}[cell]:
        assert bwd_route(torch.float32, h, cell) == "wide_f32"
        assert wf.bwd_plan(b, h, GATES[cell], H100_CLUSTERS).R <= 4


# the f32 forwards timed in turns on the H100 (python3 chip_smoke.py
# --f32-times, T = 512, B in MEASURED_B; the GRU's H = 336 also at B = 3 and
# 5, in turns twice over): at each width, the largest B at which the
# CUDA-core cluster forward ("wide") was faster than "wide_f32" (0: at
# none); "wide_f32" was faster at every larger B
MEASURED_B = (1, 2, 3, 4, 5, 6, 8, 16, 24, 32, 160)
WIDE_FASTER_UP_TO = {"lstm": {264: 0, 288: 0, 320: 0, 384: 0, 416: 0, 448: 0, 512: 0},
                     "gru": {336: 3, 352: 0, 384: 0, 416: 0, 448: 0, 512: 0}}


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_f32_forward_route_takes_the_kernel_measured_faster(cell):
    """At every width and batch the card timed, the f32 forward's route is
    the faster of the two cluster forwards; without a batch it is a large
    batch's; the batch moves no other route."""
    for H, up_to in WIDE_FASTER_UP_TO[cell].items():
        for B in MEASURED_B:
            want = "wide" if B <= up_to else "wide_f32"
            assert fwd_route(torch.float32, H, cell, B) == want, (H, B)
        assert fwd_route(torch.float32, H, cell) == "wide_f32"
    for dtype, H in ((torch.bfloat16, 336), (torch.float32, 128), (torch.float32, 1024)):
        assert fwd_route(dtype, H, cell, 1) == fwd_route(dtype, H, cell, 160) == \
            fwd_route(dtype, H, cell)


# --- the sums against the twins and the Pallas kernels ----------------------------


@pytest.mark.parametrize("cell,H", [("lstm", 264), ("lstm", 288), ("lstm", 512),
                                    ("gru", 336), ("gru", 352), ("gru", 512)])
def test_replayed_forward_matches_the_twins(cell, H):
    """The forward summed in the kernels' order (``replay_fwd``: each block's
    product over four k-quad groups of four k lanes, reduce-scattered
    (s0 + s2) + (s1 + s3), the groups added in order; H = 264 / 336 run
    zero-padded to 288 / 352 as the launchers run them) within 1e-6 of the
    twins, the LSTM's cells too."""
    args = _inputs(cell, 5, 3, H, seed=H)
    got = at_width(lambda *a: _replay(cell, *a), wf.padded(H), GATES[cell], *args)
    _close(got, _twin(cell, *args), 1e-6)


@pytest.mark.parametrize("cell,H", [("lstm", 288), ("gru", 352)])
def test_replayed_forward_matches_the_pallas_kernel(cell, H):
    """The replayed forward at f32 H = 288 (LSTM) / 352 (GRU), T = 6, B = 2,
    equals ``_bilstm_fwd_pallas`` / ``_bigru_fwd_pallas`` in interpret mode on
    the same numpy-seeded inputs."""
    args = _inputs(cell, 6, 2, H, seed=7)
    pallas = lstm_pallas._bilstm_fwd_pallas if cell == "lstm" else lstm_pallas._bigru_fwd_pallas
    want = pallas(*(jnp.asarray(a.numpy()) for a in args), interpret=True)
    got = _replay(cell, *args)
    _close(got[:len(want)], want, 1e-5)


@pytest.mark.parametrize("cell,H", [("lstm", 264), ("gru", 330)])
def test_forward_padding_is_exact(cell, H):
    """A width the kernels do not take run zero-padded to the next multiple
    of 32 (``at_width``) equals, bit for bit, the padded run cut back: the
    padded units' gates see z = 0, their h stays 0 and feeds nothing back."""
    args = _inputs(cell, 4, 2, H, seed=3)
    Hp = wf.padded(H)
    got = at_width(lambda *a: _replay(cell, *a), Hp, GATES[cell], *args)
    padded = []
    for t in args:
        if t.dim() == 2:
            t = torch.nn.functional.pad(lstm_cuda.pad_gates(t, Hp, GATES[cell]), (0, 0, 0, Hp - H))
        else:
            t = lstm_cuda.pad_gates(t, Hp, GATES[cell] if t.shape[-1] == GATES[cell] * H else 1)
        padded.append(t.contiguous())
    full = _replay(cell, *padded)
    for g, f in zip(got, full):
        assert torch.equal(g, f[..., :H])
        assert torch.all(f[..., H:] == 0)


# --- the launchers ------------------------------------------------------------------


LAUNCHERS = {"lstm": lstm_cuda.fwd_launch, "gru": gru_cuda.fwd_launch}


@pytest.mark.parametrize("cell", ["lstm", "gru"])
def test_launchers_refuse_bf16_and_widths_past_the_route(monkeypatch, cell):
    """``fwd_launch("wide_f32", …)`` raises before it builds or touches the
    card: ``TypeError`` for bf16, ``ValueError`` for H past 512 and for the
    one-block widths the route's chunks do not cover (H <= 128)."""
    monkeypatch.setattr(_build, "library", lambda: pytest.fail("the launcher reached the build"))
    bf16 = tuple(t.to(torch.bfloat16) for t in _inputs(cell, 2, 1, 512, seed=1))
    with pytest.raises(TypeError, match="float32"):
        LAUNCHERS[cell]("wide_f32", *bf16)
    for H in (544, 520, 128, 8):
        with pytest.raises(ValueError, match=f"H <= {wf.max_h(GATES[cell])}"):
            LAUNCHERS[cell]("wide_f32", *_inputs(cell, 2, 1, H, seed=1))
    assert "wide_f32" in lstm_cuda.FWD_ROUTES
