"""Deterministic synthetic demo corpus (labels + waveforms): the port's copy
of ``percivaltts_tpu/data/demo.py``, numpy only, whose output is byte for
byte the original's at the same arguments.

Reference parity: percivaltts's demo/test fixture is a downloaded
``slt_arctic_merlin_full`` subset (SURVEY.md §2 "Demo data fetch", §4
"Fixtures"). This environment has no network, so the framework ships a
*generated* miniature corpus instead: random phone sequences rendered as

* HTS state-aligned full-context label files (5 states per phone),
* waveforms from a tiny formant-style synthesizer (harmonic source with a
  per-utterance f0 contour shaped by per-phone spectral envelopes; unvoiced
  phones are shaped noise),

so the label → acoustic mapping is genuinely learnable and every pipeline
stage (question binarization, vocoder analysis, training, generation,
objective measures) can run end-to-end, deterministically, offline.
"""

from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import numpy as np

from percivaltts_tpu_torch.utils.logging import print_log

# phone inventory: name -> (voiced, formant frequencies Hz, bandwidth scale)
PHONES: Dict[str, Tuple[bool, Tuple[float, ...], float]] = {
    "sil": (False, (), 0.0),
    "aa": (True, (730.0, 1090.0, 2440.0), 1.0),
    "iy": (True, (270.0, 2290.0, 3010.0), 1.0),
    "uw": (True, (300.0, 870.0, 2240.0), 1.0),
    "eh": (True, (530.0, 1840.0, 2480.0), 1.0),
    "ow": (True, (570.0, 840.0, 2410.0), 1.0),
    "m": (True, (250.0, 1000.0, 2200.0), 0.6),
    "n": (True, (250.0, 1700.0, 2600.0), 0.6),
    "s": (False, (5000.0,), 1.5),
    "sh": (False, (3500.0,), 1.5),
    "f": (False, (4500.0,), 1.0),
    "t": (False, (4000.0,), 1.2),
    # plosives (hard mode only): closure + sharp burst + aspiration. The
    # formant entry is the burst's spectral center. Listed in PHONES so the
    # question set always carries their identities, but they are only DRAWN
    # in hard-mode utterances — the default corpus is byte-identical to the
    # pre-hard generator.
    "p": (False, (900.0,), 1.3),
    "k": (False, (1900.0,), 1.3),
}

# the stress class: phones rendered as closure->burst->aspiration transients
PLOSIVES = ("p", "k")
# default-mode pick list (hard mode appends PLOSIVES)
BASE_NAMES = [p for p in PHONES if p != "sil" and p not in PLOSIVES]

HTK_PER_SEC = 10_000_000


def _phone_envelope(
    freqs: np.ndarray, phone: str, fscale: float = 1.0
) -> np.ndarray:
    """Smooth log-amplitude envelope over linear frequencies for a phone.

    ``fscale`` multiplies every formant/burst center frequency — the
    per-instance realization jitter of the one-to-many corpus mode (see
    ``generate_demo_corpus(jitter=...)``); 1.0 reproduces the canonical
    phone exactly."""
    voiced, formants, bw = PHONES[phone]
    if phone == "sil":
        return np.full_like(freqs, -12.0)
    env = np.full_like(freqs, -6.0)
    if voiced:
        env = env - freqs / 3000.0  # spectral tilt
        for i, fc in enumerate(formants):
            width = 120.0 * (i + 1) * max(bw, 0.3)
            env = env + 3.5 * np.exp(
                -0.5 * ((freqs - fc * fscale) / width) ** 2
            )
    else:
        fc = formants[0] * fscale
        env = env - 2.0 + 2.5 * np.exp(-0.5 * ((freqs - fc) / (1200.0 * bw)) ** 2)
        env = env - np.maximum(0.0, (1500.0 - freqs)) / 700.0  # highpass-ish
    return env


def _synthesize_utterance(
    phones: Sequence[str],
    durs_sec: Sequence[float],
    fs: int,
    f0_base: float,
    rng: np.random.Generator,
    hard: bool = False,
    jitter: float = 0.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (waveform, per-sample true f0 Hz, per-sample voiced flag) —
    the ground-truth track lets tests audit the f0 estimator against moving
    f0 instead of only stationary tones (VERDICT round-2 item 3).

    ``hard`` adds the stress patterns the friendly corpus lacks (VERDICT
    round-2 item 4): plosive closure/burst transients, clicks inside
    silences, per-phone gain jitter and a slow utterance-level amplitude
    modulation. All hard-mode randomness draws AFTER the shared draws, so
    ``hard=False`` output is byte-identical to the pre-hard generator.

    ``jitter`` > 0 makes the label→acoustics mapping one-to-many: every
    phone INSTANCE scales its formant/burst center frequencies by an
    unlabeled exp(U(−jitter, +jitter)) draw, so identical label contexts map
    to a distribution of spectra (realization variability, as in real
    speech). An LSE-trained model must predict the conditional mean —
    formant peaks smeared over the jitter range, within-utterance global
    variance below natural — which is exactly the over-smoothing the WGAN
    critic exists to fix (reference ``optimizertts_wgan.py``). Draws occur
    only when jitter > 0, keeping jitter=0 output byte-identical."""
    total = int(round(sum(durs_sec) * fs))
    t = np.arange(total) / fs
    # smooth f0 contour: declination + slow vibrato
    f0 = f0_base * (1.0 - 0.15 * t / max(t[-1], 1e-6)) * (
        1.0 + 0.02 * np.sin(2 * np.pi * 3.0 * t)
    )
    phase = 2.0 * np.pi * np.cumsum(f0) / fs
    voiced_s = np.zeros(total, dtype=np.float32)

    nfft = 512
    freqs = np.fft.rfftfreq(nfft, 1.0 / fs)
    out = np.zeros(total, dtype=np.float64)
    pos = 0
    for ph, dur in zip(phones, durs_sec):
        n = int(round(dur * fs))
        sl = slice(pos, min(pos + n, total))
        m = sl.stop - sl.start
        fscale = (
            float(np.exp(rng.uniform(-jitter, jitter)))
            if jitter > 0.0 and ph != "sil"
            else 1.0
        )
        env_db = _phone_envelope(freqs, ph, fscale)
        amp = np.exp(env_db)
        voiced = PHONES[ph][0]
        if ph == "sil":
            seg = 0.001 * rng.normal(size=m)
            if hard and m > int(0.02 * fs) and rng.random() < 0.35:
                # click inside the silence (lip smack / breath onset): a
                # transient no label explains and no voicing gate expects
                bl = max(int(rng.uniform(0.002, 0.008) * fs), 4)
                at = int(rng.integers(m // 4, max(3 * m // 4, m // 4 + 1)))
                bl = min(bl, m - at)
                click = rng.normal(size=bl) * np.exp(
                    -np.arange(bl) / (0.3 * bl + 1.0)
                )
                seg[at : at + bl] += 0.25 * click
        elif hard and ph in PLOSIVES:
            # closure -> burst -> aspiration: the sharpest transient class
            # in real speech. Instant attack (no ramp), ~4 ms decay.
            seg = np.zeros(m)
            clo = int(0.55 * m)
            seg[:clo] = 0.0005 * rng.normal(size=clo)
            bn = min(m - clo, max(int(0.012 * fs), 8))
            white = rng.normal(size=max(bn, nfft))
            W = np.fft.rfft(white)
            wf = np.fft.rfftfreq(len(white), 1.0 / fs)
            burst = np.fft.irfft(W * np.interp(wf, freqs, amp))[:bn]
            burst = burst * np.exp(-np.arange(bn) / (0.004 * fs))
            seg[clo : clo + bn] += 2.5 * burst
            an = m - clo - bn
            if an > 0:
                wh2 = rng.normal(size=max(an, nfft))
                W2 = np.fft.rfft(wh2)
                wf2 = np.fft.rfftfreq(len(wh2), 1.0 / fs)
                seg[clo + bn :] = (
                    0.12 * np.fft.irfft(W2 * np.interp(wf2, freqs, amp))[:an]
                )
        elif voiced:
            voiced_s[sl] = 1.0
            seg = np.zeros(sl.stop - sl.start)
            f0m = float(np.mean(f0[sl]))
            K = int(fs / 2 / f0m) - 1
            for k in range(1, K + 1):
                fk = k * f0m
                a = np.interp(fk, freqs, amp)
                seg = seg + a * np.cos(k * phase[sl])
            seg = seg * 0.1
        else:
            white = rng.normal(size=sl.stop - sl.start)
            W = np.fft.rfft(white, n=max(len(white), nfft))
            wf = np.fft.rfftfreq(max(len(white), nfft), 1.0 / fs)
            W = W * np.interp(wf, freqs, amp)
            seg = np.fft.irfft(W)[: sl.stop - sl.start] * 0.35
        # short crossfade ramps to avoid clicks
        ramp = min(80, max(len(seg) // 8, 1))
        win = np.ones(len(seg))
        win[:ramp] = np.linspace(0, 1, ramp)
        win[-ramp:] = np.linspace(1, 0, ramp)
        # per-phone gain jitter (hard): +-6 dB of amplitude dynamics the
        # labels do not encode
        g = float(np.exp(rng.uniform(-0.7, 0.7))) if hard else 1.0
        out[sl] += seg * win * g
        pos += n
    if hard:
        # slow utterance-level amplitude modulation (~+-4 dB)
        am_rate = float(rng.uniform(0.4, 1.2))
        am_phase = float(rng.uniform(0.0, 2.0 * np.pi))
        out = out * np.exp(0.45 * np.sin(2.0 * np.pi * am_rate * t + am_phase))
    peak = np.abs(out).max()
    if peak > 0:
        out = out / peak * 0.6
    return out.astype(np.float32), f0.astype(np.float32), voiced_s


def _utterance_plan(
    rng: np.random.Generator,
    names: Sequence[str],
    min_phones: int,
    max_phones: int,
    hard: bool,
) -> Tuple[List[str], List[float], float]:
    """Draw one utterance's (phone sequence, durations, f0_base) — the part
    of the corpus an oracle predictor could know from the labels. Shared by
    ``generate_demo_corpus`` and ``replay_corpus_plans`` so the two consume
    the RNG identically."""
    nph = int(rng.integers(min_phones, max_phones + 1))
    seq = (
        ["sil"]
        + [names[int(rng.integers(len(names)))] for _ in range(nph)]
        + ["sil"]
    )
    durs = [
        float(rng.uniform(0.05, 0.12))
        if p != "sil"
        else float(rng.uniform(0.08, 0.15))
        for p in seq
    ]
    # quantize durations to whole 5 ms frames, 5 states per phone
    shift = 0.005
    durs = [max(round(d / shift), 5) * shift for d in durs]
    # always draw (keeps the RNG sequence — and thus every other mode's
    # output — byte-identical), then pin for the single-speaker mode
    f0_base = float(
        rng.uniform(75.0, 285.0) if hard else rng.uniform(110.0, 220.0)
    )
    return seq, durs, f0_base


def _apply_stressors(
    wav: np.ndarray,
    fs: int,
    seed: int,
    u: int,
    noise_snr_db: float,
    reverb_ms: float,
) -> np.ndarray:
    """Acoustic-condition stressors (round-5 corpus-realism axis): additive
    background noise at a given SNR and/or a synthetic room reverb
    (exponential-decay noise impulse response). Drawn from a rng derived
    from (seed, utterance index) so the BASE corpus draws — labels, f0,
    phone realizations — stay byte-identical to the unstressed corpus,
    making stressed/unstressed A/Bs differ only in acoustic conditions."""
    if noise_snr_db <= 0 and reverb_ms <= 0:
        return wav
    srng = np.random.default_rng([seed, u, 2077])
    out = wav.astype(np.float64)
    if reverb_ms > 0:
        L = max(int(fs * reverb_ms / 1000.0), 8)
        tail = srng.normal(size=L) * np.exp(-6.9 * np.arange(L) / L)
        ir = np.concatenate([[1.0], 0.35 * tail])  # direct path + tail
        ir = ir / np.sqrt(np.sum(ir * ir))
        out = np.convolve(out, ir)[: len(out)]
    if noise_snr_db > 0:
        sig = float(np.sqrt(np.mean(out * out)) + 1e-12)
        out = out + (sig / 10.0 ** (noise_snr_db / 20.0)) * srng.normal(
            size=len(out)
        )
    peak = np.abs(out).max()
    if peak > 0:
        out = out / peak * 0.6
    return out.astype(np.float32)


def replay_corpus_plans(
    num_utterances: int,
    fs: int = 16000,
    seed: int = 1234,
    min_phones: int = 6,
    max_phones: int = 12,
    hard: bool = False,
    jitter: float = 0.0,
    speaker_f0: float = 0.0,
):
    """Re-derive each utterance's (uid, phones, durations, f0_base,
    canonical waveform) for ``generate_demo_corpus(same args)`` without
    touching disk. Consumes the RNG exactly as the generator does
    (synthesis draws included), so ALTERNATE realizations of any utterance
    — same labels, fresh noise/jitter draws — can be rendered via
    ``_synthesize_utterance(seq, durs, fs, f0_base, fresh_rng, ...)``.
    This is the Monte-Carlo oracle of ``scripts/pred_budget.py``: the mean
    over alternates is the best label(+f0)-informed predictor, whose error
    vs the canonical realization is the corpus's irreducible floor."""
    rng = np.random.default_rng(seed)
    names = BASE_NAMES + ([p for p in PLOSIVES] if hard else [])
    for u in range(num_utterances):
        seq, durs, f0_base = _utterance_plan(
            rng, names, min_phones, max_phones, hard
        )
        if speaker_f0 > 0:
            f0_base = float(speaker_f0)
        wav, _, _ = _synthesize_utterance(
            seq, durs, fs, f0_base, rng, hard=hard, jitter=jitter
        )
        yield f"demo{u:04d}", seq, durs, f0_base, wav


def generate_demo_corpus(
    root: str,
    num_utterances: int = 20,
    fs: int = 16000,
    seed: int = 1234,
    min_phones: int = 6,
    max_phones: int = 12,
    hard: bool = False,
    jitter: float = 0.0,
    speaker_f0: float = 0.0,
    encode_f0: bool = False,
    noise_snr_db: float = 0.0,
    reverb_ms: float = 0.0,
) -> List[str]:
    """Write a miniature corpus under ``root``: ``wav/``,
    ``label_state_align/``, ``questions.hed``, ``fileids.scp``.
    Returns the file-id list.

    ``speaker_f0`` > 0 pins every utterance's base f0 to that value
    (single-speaker corpus, like the reference's slt_arctic demo data).
    The default draws ``f0_base ~ uniform`` per utterance WITHOUT encoding
    it in the labels, which makes ~30 Hz of F0 RMSE irreducible from labels
    by construction (measured: `scripts/f0_attrib.py`, BASELINE.md
    "attribution CLOSED" row) — like a multi-speaker corpus with no speaker
    feature. With a pinned speaker f0 the contour (declination + fixed
    vibrato) is largely label-predictable, so end-to-end F0 RMSE becomes a
    model-quality signal. Labels/questions are byte-identical either way
    (f0 never enters them); the RNG draw sequence is preserved.

    ``hard=True`` raises difficulty toward real-corpus conditions (VERDICT
    round-2 item 4): plosive phones (closure/burst transients), clicks
    inside silences, per-phone/utterance amplitude dynamics, and a wider
    per-speaker f0 range reaching near the analyzer's ``f0_min`` (75–285 Hz
    base vs the friendly 110–220). ``hard=False`` output is byte-identical
    to the pre-hard generator.

    ``jitter`` > 0 (e.g. 0.12 = ±12 % formant shifts) makes the mapping
    one-to-many per phone instance — the over-smoothing stress corpus for
    LSE-vs-WGAN studies; see ``_synthesize_utterance``.

    ``encode_f0=True`` writes each utterance's base f0 INTO the labels
    (context suffix ``&<hz>!`` + a ``CQS "F0_Base"`` question) — the
    round-5 corpus-realism axis: the default corpus's per-utterance f0
    draw is label-unencoded and makes ~30 Hz of F0 RMSE irreducible by
    construction (BASELINE.md "attribution CLOSED"); encoding it is the
    equivalent of a real corpus's speaker/prosody features and turns F0
    RMSE into a model-limited metric. Default False keeps labels and
    questions byte-identical.

    ``noise_snr_db`` > 0 / ``reverb_ms`` > 0 add acoustic-condition
    stressors (background noise at that SNR; exponential-tail room
    reverb) from a derived rng — base draws stay byte-identical, so
    stressed/unstressed corpora differ only in acoustic conditions (see
    ``_apply_stressors``)."""
    from percivaltts_tpu_torch.data.compose import save_wav

    rng = np.random.default_rng(seed)
    wav_dir = os.path.join(root, "wav")
    lab_dir = os.path.join(root, "label_state_align")
    f0_dir = os.path.join(root, "f0ref")
    os.makedirs(wav_dir, exist_ok=True)
    os.makedirs(lab_dir, exist_ok=True)
    os.makedirs(f0_dir, exist_ok=True)

    names = BASE_NAMES + ([p for p in PLOSIVES] if hard else [])
    # question set: identity of prev/current/next phone + positional CQS.
    # Only phones this corpus can contain get questions — the default-mode
    # questions.hed stays byte-identical to the pre-hard generator (plosive
    # questions would add six always-zero label columns and perturb every
    # deterministic training fixture downstream)
    q_phones = ["sil"] + names
    with open(os.path.join(root, "questions.hed"), "w") as q:
        for p in q_phones:
            q.write(f'QS "C-{p}" {{*-{p}+*}}\n')
            q.write(f'QS "L-{p}" {{*^{p}-*}}\n')
            q.write(f'QS "R-{p}" {{*+{p}=*}}\n')
        q.write('QS "C-Voiced" {'
                + ",".join(f"*-{p}+*" for p, (v, _, _) in PHONES.items() if v)
                + "}\n")
        q.write('CQS "Pos_Phone_Fw" {@(\\d+)_}\n')
        if encode_f0:
            q.write('CQS "F0_Base" {&(\\d+)!}\n')

    shift = 0.005
    ids: List[str] = []
    for u in range(num_utterances):
        uid = f"demo{u:04d}"
        ids.append(uid)
        seq, durs, f0_base = _utterance_plan(
            rng, names, min_phones, max_phones, hard
        )
        if speaker_f0 > 0:
            f0_base = float(speaker_f0)
        wav, f0_s, voiced_s = _synthesize_utterance(
            seq, durs, fs, f0_base, rng, hard=hard, jitter=jitter
        )
        wav = _apply_stressors(wav, fs, seed, u, noise_snr_db, reverb_ms)
        save_wav(os.path.join(wav_dir, uid + ".wav"), fs, wav)
        # ground-truth f0 reference at the 5 ms frame rate: (nf, 2) columns
        # [f0_hz, voiced] sampled at frame centers — lets tests attribute
        # estimator error separately from model error
        hop = int(round(shift * fs))
        centers = np.arange(0, len(wav), hop)
        np.save(
            os.path.join(f0_dir, uid + ".npy"),
            np.stack(
                [f0_s[centers], voiced_s[centers]], axis=1
            ).astype(np.float32),
        )

        lines = []
        t_units = 0
        for i, (ph, dur) in enumerate(zip(seq, durs)):
            prev = seq[i - 1] if i > 0 else "x"
            nxt = seq[i + 1] if i + 1 < len(seq) else "x"
            ctx = f"x^{prev}-{ph}+{nxt}=x@{i}_{len(seq) - i}"
            if encode_f0:
                ctx += f"&{int(round(f0_base))}!"
            frames = int(round(dur / shift))
            per_state = [frames // 5] * 5
            for j in range(frames - sum(per_state)):
                per_state[j % 5] += 1
            for s, nfr in enumerate(per_state):
                dur_units = nfr * int(shift * HTK_PER_SEC)
                lines.append(f"{t_units} {t_units + dur_units} {ctx}[{s + 2}]")
                t_units += dur_units
        with open(os.path.join(lab_dir, uid + ".lab"), "w") as f:
            f.write("\n".join(lines) + "\n")

    with open(os.path.join(root, "fileids.scp"), "w") as f:
        f.write("\n".join(ids) + "\n")
    print_log(f"generated demo corpus: {num_utterances} utterances at {root}")
    return ids
