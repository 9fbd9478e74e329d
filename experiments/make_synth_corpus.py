#!/usr/bin/env python3
"""Generate a synthetic multi-speaker corpus for accuracy experiments.

Each "speaker" is a source-filter voice: a glottal-like pulse train at a
speaker-specific F0 (with jitter and drift) filtered by speaker-specific
formant resonators, plus breath noise and amplitude modulation. This is not
a substitute for the reference's real 102-speaker corpus (unavailable
here), but it exercises the same pipeline decisions and gives a stable
accuracy yardstick across rounds.

Usage: python experiments/make_synth_corpus.py /tmp/synthcorpus --speakers 20 --seconds 60
"""

import argparse
import os
import sys

import numpy as np
import scipy.io.wavfile as wavfile
import scipy.signal as sig

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.realpath(__file__))))

FS = 8000


def make_speaker(rng):
    return {
        "f0": 80 + rng.rand() * 160,                 # 80..240 Hz
        "formants": sorted(300 + rng.rand(4) * 2700),
        "bandwidths": 60 + rng.rand(4) * 120,
        "breath": 0.02 + rng.rand() * 0.08,
        "vibrato": 2 + rng.rand() * 4,
    }


# -- hard mode (VERDICT r3 item 5): a corpus whose closed-set accuracy
# lands in the reference's 0.92-0.99 regime instead of saturating at 1.0.
# Speakers are drawn as SMALL perturbations around a few shared prototype
# voices (overlapping formant families), every utterance gets per-session
# drift of the vocal-tract parameters (within-speaker variance comparable
# to between-speaker distances), and babble-ish additive noise at a fixed
# SNR. The difficulty knobs are (n_prototypes, speaker_spread,
# session_spread, snr_db). Defaults are tuned (r3) so the closed-set
# curve lands at ~0.93-0.97 for 20-40 speakers — the reference's golden
# regime — instead of saturating.

def make_prototypes(rng, n_prototypes=6):
    protos = []
    for _ in range(n_prototypes):
        protos.append({
            "f0": 90 + rng.rand() * 130,
            "formants": np.sort(np.array(
                [300 + rng.rand() * 500, 900 + rng.rand() * 700,
                 1800 + rng.rand() * 800, 2700 + rng.rand() * 900])),
            "bandwidths": 70 + rng.rand(4) * 100,
        })
    return protos


def make_hard_speaker(rng, protos, speaker_spread=0.06):
    p = protos[rng.randint(len(protos))]
    return {
        "f0": p["f0"] * (1 + speaker_spread * rng.randn()),
        "formants": p["formants"] * (1 + speaker_spread * rng.randn(4)),
        "bandwidths": p["bandwidths"] * (1 + 0.2 * rng.randn(4)),
        "breath": 0.04 + rng.rand() * 0.06,
        "vibrato": 2 + rng.rand() * 4,
    }


def synth(spk, seconds, rng, session_spread=0.0, snr_db=None):
    n = int(FS * seconds)
    t = np.arange(n) / FS
    # per-session (per-utterance) drift of the voice parameters
    f0_base = spk["f0"] * (1 + session_spread * rng.randn())
    formants = np.asarray(spk["formants"]) * (
        1 + session_spread * rng.randn(len(spk["formants"])))
    # pulse train with vibrato + jitter
    f0 = f0_base * (1 + 0.03 * np.sin(2 * np.pi * spk["vibrato"] * t)
                    + 0.01 * rng.randn())
    phase = np.cumsum(f0) / FS
    pulses = (np.diff(np.floor(phase), prepend=0.0) > 0).astype(np.float64)
    excitation = pulses + spk["breath"] * rng.randn(n)
    # cascade of formant resonators
    out = excitation
    for f, bw in zip(formants, spk["bandwidths"]):
        f = float(np.clip(f, 120.0, FS / 2 - 200.0))
        r = np.exp(-np.pi * bw / FS)
        theta = 2 * np.pi * f / FS
        a = [1, -2 * r * np.cos(theta), r * r]
        out = sig.lfilter([1 - r], a, out)
    # syllable-ish amplitude modulation with pauses
    env = np.clip(np.sin(2 * np.pi * (2.5 + rng.rand()) * t
                         + rng.rand() * 6.28), 0, None) ** 0.5
    out = out * (0.25 + 0.75 * env)
    out = out / (np.abs(out).max() + 1e-9)
    if snr_db is not None:
        # "babble": sum of a few detuned voices' envelopes of filtered noise
        noise = rng.randn(n)
        noise = sig.lfilter([1.0], [1.0, -0.9], noise)  # pink-ish tilt
        noise = noise / (np.std(noise) + 1e-9)
        p_sig = np.mean(out ** 2)
        out = out + noise * np.sqrt(p_sig / (10 ** (snr_db / 10.0)))
        out = out / (np.abs(out).max() + 1e-9)
    return (out * 12000).astype(np.int16)


# -- UBM-anchored mode (VERDICT r3 item 5 / missing 1): speakers are
# all-pole vocal tracts whose filters come from the reference's OWN shipped
# 256-mixture UBM (src/gui/model/ubm.mixture-256.nperson-300.immature.model,
# trained on 300 real utterances of the 102-speaker corpus,
# doc/Final-Report-Complete/dataset.tex:8-21). Each UBM component's mean
# vector carries the LPC coefficients a1..a15 of real pre-emphasized speech
# frames (dims 19..33 of the 34-dim bob-MFCC(19)+LPC(15) feature space), so
# 1/A(z) built from a component IS a vocal-tract envelope observed in real
# speech. A "phone" = one component; a speaker = per-speaker warp (pole-
# angle scale ~ vocal-tract length, F0, breathiness) over a shared phone
# inventory; an utterance = a random phone sequence with glottal pulse /
# noise excitation synthesized in the pre-emphasis domain and de-emphasized.
# Realism is MEASURED, not asserted: experiments/ubm_anchor.py scores the
# corpus's 34-dim features under the UBM against the UBM's own typical-set
# band (the r3 corpus measured mean per-frame ll ~ -72 vs the band
# [-33, +4]; the anchored generator must land inside).

UBM_PATH = ("/root/reference/src/gui/model/"
            "ubm.mixture-256.nperson-300.immature.model")


def load_ubm_phones(path=UBM_PATH, n_phones=48, seed=0):
    """(weights [P], lpc_A [P, 16], mfcc_means [P, 19]) for the n_phones
    highest-probability-mass sampled components of the reference UBM."""
    import sys as _sys
    _sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.realpath(__file__))))
    from speaker_recognition.utils import serialization
    with open(path) as f:
        ubm = serialization.load_reference_gmm(f)
    rng = np.random.RandomState(seed)
    w = ubm.weights / ubm.weights.sum()
    idx = rng.choice(len(w), size=min(n_phones, len(w)), replace=False, p=w)
    A = np.concatenate([np.ones((len(idx), 1)),
                        ubm.means[idx, 19:34]], axis=1)   # [P, 16]
    return w[idx] / w[idx].sum(), A, ubm.means[idx, :19]


def _stabilize(A, max_radius=0.97):
    """Reflect any outside-unit-circle roots of A(z) inside and clamp the
    radius: component means average LPC frames, which need not stay
    minimum-phase."""
    r = np.roots(A)
    r = np.where(np.abs(r) >= 1.0, 1.0 / np.conj(r), r)
    mag = np.abs(r)
    r = np.where(mag > max_radius, r * (max_radius / mag), r)
    return np.real(np.poly(r))


def _warp_poles(A, angle_scale, radius_pow=1.0):
    """Vocal-tract-length-style warp: scale every pole's angle; optional
    bandwidth warp via a power on the pole radii (radius_pow > 1 widens
    formant bandwidths, < 1 sharpens)."""
    r = np.roots(A)
    warped = np.abs(r) ** radius_pow * np.exp(1j * np.angle(r) * angle_scale)
    return np.real(np.poly(warped))


def select_ubm_phones(path=UBM_PATH, candidates=96, keep=24, seed=0,
                      excitation="pulse"):
    """Quality-select the phone inventory: synthesize each candidate
    component with the STYLE'S excitation and keep the `keep` components
    whose output scores best under the UBM itself (self-likelihood
    ranking).

    The UBM mixes voiced-speech components with whisper/fricative/noise
    ones whose mean-LPC filters make poor pulse-excited phones (measured
    self-ll spread: -72 to -28 across 96 candidates); selecting the top
    quartile moved the corpus-level anchor score from ~ -55 to ~ -45
    (experiments/results/r4_ubm_anchor.jsonl). For the READING style all
    candidates score better under pulse than noise excitation (voiced
    fraction 1.0 in the r4 measurement). The WHISPER style inverts the
    criterion: ranking by NOISE-excited self-likelihood picks the UBM's
    own breathy/fricative components — with pulse-ranked phones the
    80-speaker whisper corpus measured a 27.9-nat band gap
    (r5_ubm_anchor.jsonl) because voiced-phone envelopes excited by
    noise are off the manifold of the UBM's whisper training frames."""
    import jax.numpy as jnp
    import scipy.signal as _sig
    from speaker_recognition.models import gmm as _gmm
    from speaker_recognition.features import extract as _extract
    from speaker_recognition.config import (FeatureConfig, LpcConfig,
                                                bob_mfcc_config)
    from speaker_recognition.utils import serialization
    with open(path) as f:
        ubm = serialization.load_reference_gmm(f)
    cfg = FeatureConfig(mfcc=bob_mfcc_config(cmvn=False), lpc=LpcConfig(),
                        use_lpc=True)
    p = _gmm.GmmParams(*(jnp.asarray(a, jnp.float32) for a in ubm))
    w, A, mf = load_ubm_phones(path, candidates, seed)
    rng = np.random.RandomState(seed)
    t = np.arange(FS)
    scores = []
    for j in range(len(w)):
        Aj = _stabilize(A[j])
        if excitation == "noise":
            exc = rng.randn(FS)
        else:
            f0 = 140.0
            ph = np.cumsum(np.full(FS, f0 * (1 + 0.1 * np.sin(
                2 * np.pi * 3 * t / FS)))) / FS
            exc = (np.diff(np.floor(ph), prepend=0) > 0).astype(float) \
                * np.sqrt(FS / f0) + 0.08 * rng.randn(FS)
        x = _sig.lfilter([1.0], [1.0, -0.95], _sig.lfilter([1.0], Aj, exc))
        x = x / np.abs(x).max() * 9000
        feat = _extract.mix_feature(FS, x.astype(np.float64), cfg)
        scores.append(float(np.asarray(_gmm.per_frame_loglik(
            p, jnp.asarray(feat, jnp.float32), 1e-15)).mean()))
    idx = np.argsort(np.asarray(scores))[-keep:]
    return w[idx] / w[idx].sum(), A[idx], mf[idx]


def make_identity_loadings(P, rank, seed=777):
    """Cross-phone identity loading matrices, one per pole parameter
    (angle, radius). Rows are unit-norm, so a rank-r draw z ~ N(0, I_r)
    gives every phone the SAME marginal perturbation variance as the
    i.i.d. draw — only the cross-phone covariance changes (rank r instead
    of full rank P). This is the structure real voices have and the
    i.i.d. generator lacks (r5_jfa_channel.jsonl mechanism note): vocal-
    tract length/shape are a few anatomical degrees of freedom that
    correlate the formants of every phone a speaker produces, which is
    the premise of JFA's low-rank eigenvoice model (estimate_y_and_v.m).
    The seed is fixed per corpus FAMILY (not per corpus): background and
    evaluation casts must share the loading subspace for an eigenvoice
    basis learned on one to transfer to the other, exactly as real
    background and target speakers share human anatomy."""
    rng = np.random.RandomState(seed)
    L_angle = rng.randn(P, rank)
    L_angle /= np.linalg.norm(L_angle, axis=1, keepdims=True)
    L_radius = rng.randn(P, rank)
    L_radius /= np.linalg.norm(L_radius, axis=1, keepdims=True)
    return L_angle, L_radius


def make_ubm_speaker(rng, phones, speaker_spread=0.04, phone_jitter=0.065,
                     identity=None):
    """A speaker = global vocal-tract-length warp + F0 + breathiness PLUS
    a per-phone 'accent': independent angle/bandwidth perturbations of
    each phone's poles. The global warp alone leaves speakers nearly
    indistinguishable to a CMVN'd GMM (measured 0.27 accuracy at 20
    speakers); phone_jitter is the speaker-identity knob that tunes the
    closed-set curve into the reference's regime.

    identity = (L_angle, L_radius, rho) switches the per-phone draw from
    i.i.d. to a low-rank-correlated one: a fraction rho of each phone's
    perturbation variance comes from a shared rank-r subspace (see
    make_identity_loadings), the rest stays i.i.d. — the same split JFA
    itself models as v·y (low-rank eigenvoices) + d·z (diagonal
    residual), train_all.m stages 1+3."""
    w, A, _ = phones
    P = len(w)
    # rng draw order below is frozen for identity=None: it reproduces the
    # r4/r5 corpora bit-for-bit from their recorded seeds
    f0 = 95 + rng.rand() * 130
    angle_scale = 1.0 + speaker_spread * rng.randn()
    if identity is None:
        pa = rng.randn(P)
        pr = rng.randn(P)
    else:
        L_angle, L_radius, rho = identity
        r = L_angle.shape[1]
        pa = (np.sqrt(rho) * (L_angle @ rng.randn(r))
              + np.sqrt(1.0 - rho) * rng.randn(P))
        pr = (np.sqrt(rho) * (L_radius @ rng.randn(r))
              + np.sqrt(1.0 - rho) * rng.randn(P))
    return {
        "f0": f0,
        "angle_scale": angle_scale,
        "phone_angle": 1.0 + phone_jitter * pa,
        "phone_radius": 1.0 + 0.5 * phone_jitter * pr,
        "breath": 0.08 + rng.rand() * 0.12,
        "vibrato": 2 + rng.rand() * 4,
        # per-speaker phone-frequency tilt (speaking-style idiosyncrasy)
        "phone_w": np.maximum(w * (1 + 0.3 * rng.randn(len(w))), 1e-4),
    }


# Style analogues of the reference corpus's speaking styles
# (doc/Final-Report-Complete/dataset.tex:8-21: Reading / Spontaneous /
# Whisper; the published whisper accuracy row is nperson-mix-1523-t5-
# whisper.log). "whisper" = no voicing at all: every phone is excited by
# aspiration noise shaped by the same speaker-warped vocal tract, with
# slightly widened formant bandwidths (radius_pow > 1 pulls poles toward
# the origin) — the F0/glottal identity cues disappear and only the
# tract warp carries the speaker, which is exactly why the reference's
# whisper accuracy sits below its reading accuracy.
STYLE_PARAMS = {
    "reading": {},
    "whisper": {"unvoiced_frac": 1.0, "whisper_radius_pow": 1.06,
                "excitation": "noise"},  # phone-selection criterion
}


def synth_ubm(spk, phones, seconds, rng, session_spread=0.015,
              unvoiced_frac=0.25, breath_scale=1.0, jitter=0.15,
              shimmer=0.25, attack_ms=20.0, pause_p=0.05,
              whisper_radius_pow=1.0, noise_tilt=0.0):
    """One utterance: random phone sequence, glottal-pulse/noise excitation
    through the (speaker-warped, session-drifted) UBM all-pole filters in
    the pre-emphasis domain, then de-emphasis.

    The aperiodicity knobs (jitter = per-period F0 perturbation, shimmer =
    per-pulse amplitude perturbation, breath_scale on the speaker's
    aspiration level) were tuned against the UBM typical-set check
    (experiments/ubm_anchor.py): an overly regular pulse train leaves a
    harmonic comb in the log-mel spectrum that real speech does not have,
    which showed up as +2sigma means on mid cepstral dims."""
    _, A_all, _ = phones
    n = int(FS * seconds)
    out = np.zeros(n)
    pw = spk["phone_w"] / spk["phone_w"].sum()
    angle_scale = spk["angle_scale"] * (1 + session_spread * rng.randn())
    f0_base = spk["f0"] * (1 + session_spread * rng.randn())
    pos = 0
    zi = None
    stab_cache = {}
    while pos < n:
        if rng.rand() < pause_p:  # brief pause between phone runs
            dur = int(FS * (0.03 + 0.1 * rng.rand()))
            end = min(pos + dur, n)
            out[pos:end] += 0.003 * rng.randn(end - pos)
            pos += dur
            zi = None
            continue
        k = rng.choice(len(pw), p=pw)
        if k not in stab_cache:
            stab_cache[k] = _stabilize(A_all[k])
        pa = spk.get("phone_angle")
        pr = spk.get("phone_radius")
        A = _stabilize(_warp_poles(
            stab_cache[k],
            angle_scale * (pa[k] if pa is not None else 1.0),
            (pr[k] if pr is not None else 1.0) * whisper_radius_pow))
        dur = int(FS * (0.06 + 0.14 * rng.rand()))
        dur = min(dur, n - pos)
        if dur <= 0:
            break
        t = np.arange(dur) / FS
        voiced = rng.rand() > unvoiced_frac
        if voiced:
            # F0 contour: vibrato + slow random walk; per-sample jitter is
            # integrated into the phase so each period's length varies
            walk = np.cumsum(rng.randn(dur)) / np.sqrt(max(dur, 1))
            f0 = f0_base * (1 + 0.03 * np.sin(
                2 * np.pi * spk["vibrato"] * (t + pos / FS))
                + 0.03 * walk
                + jitter * np.repeat(rng.randn(dur // 64 + 1), 64)[:dur])
            phase = np.cumsum(np.maximum(f0, 40.0)) / FS + rng.rand()
            pulses = (np.diff(np.floor(phase), prepend=np.floor(phase[0]))
                      > 0).astype(np.float64)
            # shimmer: each pulse gets its own amplitude
            amp = 1.0 + shimmer * rng.randn(int(pulses.sum()) or 1)
            pulses[pulses > 0] = np.abs(amp[: int(pulses.sum())])
            exc = pulses * np.sqrt(FS / f0_base)
            exc = exc + breath_scale * spk["breath"] * rng.randn(dur)
        else:
            exc = rng.randn(dur)
            if noise_tilt:
                # shaped aspiration: glottal turbulence is not white
                exc = sig.lfilter([1.0], [1.0, -noise_tilt], exc)
                exc = exc / (np.std(exc) + 1e-9)
        env = np.minimum(1.0, np.minimum(
            np.arange(dur) / (attack_ms * 1e-3 * FS),
            (dur - np.arange(dur)) / (attack_ms * 1e-3 * FS)))
        exc = exc * (0.5 + 0.5 * rng.rand()) * np.clip(env, 0.05, 1.0)
        seg, zi_new = sig.lfilter([1.0], A, exc, zi=np.zeros(len(A) - 1)
                                  if zi is None or len(zi) != len(A) - 1
                                  else zi)
        zi = zi_new
        out[pos:pos + dur] += seg
        pos += dur
    # de-emphasis: synthesis ran in the pre-emphasized domain the UBM's LPC
    # features were computed in (LPC.py:50-52 pre-emphasizes each frame)
    out = sig.lfilter([1.0], [1.0, -0.95], out)
    out = out / (np.abs(out).max() + 1e-9)
    return (out * 12000).astype(np.int16)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("outdir")
    ap.add_argument("--speakers", type=int, default=20)
    ap.add_argument("--seconds", type=float, default=60.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--hard", action="store_true",
                    help="overlapping-prototype speakers + session drift "
                         "+ additive noise (non-saturated accuracy)")
    ap.add_argument("--ubm", action="store_true",
                    help="UBM-anchored speakers: all-pole vocal tracts from "
                         "the reference's shipped 256-mix UBM (see header)")
    ap.add_argument("--ubm-path", default=UBM_PATH)
    ap.add_argument("--style", choices=sorted(STYLE_PARAMS), default="reading",
                    help="ubm mode: speaking-style analogue (dataset.tex:8-21"
                         "; whisper = noise-excited, widened bandwidths)")
    ap.add_argument("--phones", type=int, default=96,
                    help="ubm mode: candidate components for selection")
    ap.add_argument("--keep-phones", type=int, default=24,
                    help="ubm mode: phones kept by self-likelihood ranking")
    ap.add_argument("--phone-jitter", type=float, default=0.065,
                    help="ubm mode: per-speaker per-phone pole perturbation "
                         "(the speaker-identity / difficulty knob; 0.065 "
                         "measured jointly best for realism gap AND "
                         "reference-regime accuracy, r4_ubm_anchor.jsonl)")
    ap.add_argument("--identity-rank", type=int, default=0,
                    help="ubm mode: 0 = i.i.d. per-phone identity (the "
                         "r4/r5 default); r > 0 draws a fraction "
                         "--identity-rho of each phone's perturbation "
                         "variance from a shared rank-r cross-phone "
                         "subspace (real-voice anatomy structure; gives "
                         "JFA's eigenvoices something to estimate)")
    ap.add_argument("--identity-rho", type=float, default=0.75,
                    help="ubm mode: shared-subspace variance fraction "
                         "when --identity-rank > 0 (marginal per-phone "
                         "variance is preserved either way)")
    ap.add_argument("--identity-seed", type=int, default=777,
                    help="ubm mode: seed of the loading matrices — fixed "
                         "per corpus FAMILY so background and eval casts "
                         "share the subspace (use the same value for "
                         "corpora that must be JFA-compatible)")
    ap.add_argument("--phone-seed", type=int, default=None,
                    help="ubm mode: seed for phone-inventory selection "
                         "(default: --seed). Corpora that must share a "
                         "phone inventory (e.g. JFA background + eval) "
                         "should pass the same value with different "
                         "--seed speaker casts")
    ap.add_argument("--prototypes", type=int, default=8)
    ap.add_argument("--speaker-spread", type=float, default=0.10)
    ap.add_argument("--session-spread", type=float, default=0.03)
    ap.add_argument("--snr-db", type=float, default=15.0)
    ap.add_argument("--segments", type=int, default=8,
                    help="hard mode: utterances per speaker (each with its "
                         "own session drift), concatenated")
    args = ap.parse_args()

    os.makedirs(args.outdir, exist_ok=True)
    rng = np.random.RandomState(args.seed)
    if args.ubm:
        if not 0.0 <= args.identity_rho <= 1.0:
            ap.error(f"--identity-rho must be in [0, 1], got "
                     f"{args.identity_rho} (sqrt(1-rho) would be NaN and "
                     f"every speaker's poles garbage)")
        phone_seed = args.seed if args.phone_seed is None else args.phone_seed
        phones = select_ubm_phones(
            args.ubm_path, args.phones, args.keep_phones, phone_seed,
            excitation=STYLE_PARAMS[args.style].get("excitation", "pulse"))
        identity = None
        if args.identity_rank > 0:
            L_a, L_r = make_identity_loadings(
                len(phones[0]), args.identity_rank, args.identity_seed)
            identity = (L_a, L_r, args.identity_rho)
        spread = (args.speaker_spread if args.speaker_spread != 0.10
                  else 0.03)  # ubm-mode default (v6+: phone_jitter carries
                              # identity; the global warp stays small)
        sess = (args.session_spread if args.session_spread != 0.03
                else 0.015)  # ubm-mode default (0.03 is the hard-mode one)

        # Speaker-level cast selection: the warp/jitter draws have a tail
        # of voices whose spectra fall off the UBM manifold (measured:
        # 40-draw corpora score ~4 nats worse than 6-draw probes). Each
        # candidate speaker is probed with a short utterance and redrawn
        # while its mean per-frame UBM ll is under the gate -- rejection
        # on REALISM only, never on distinctness, so the identity knobs
        # (phone_jitter, spread) keep their meaning.
        import jax.numpy as _jnp
        from speaker_recognition.models import gmm as _gmm
        from speaker_recognition.features import extract as _extract
        from speaker_recognition.config import (FeatureConfig,
                                                    LpcConfig,
                                                    bob_mfcc_config)
        from speaker_recognition.utils import serialization as _ser
        with open(args.ubm_path) as f:
            _ubm = _ser.load_reference_gmm(f)
        _p = _gmm.GmmParams(*(_jnp.asarray(a, _jnp.float32) for a in _ubm))
        _cfg34 = FeatureConfig(mfcc=bob_mfcc_config(cmvn=False),
                               lpc=LpcConfig(), use_lpc=True)

        style_kw = dict(STYLE_PARAMS[args.style])
        style_kw.pop("excitation", None)  # phone-selection only

        def speaker_ll(spk, probe_rng):
            wav = synth_ubm(spk, phones, 4.0, probe_rng,
                            session_spread=0.0, **style_kw)
            feat = _extract.mix_feature(FS, wav.astype(np.float64), _cfg34)
            return float(np.asarray(_gmm.per_frame_loglik(
                _p, _jnp.asarray(feat, _jnp.float32), 1e-15)).mean())

        SPK_LL_GATE = -52.0
        for i in range(args.speakers):
            for attempt in range(12):
                spk = make_ubm_speaker(rng, phones, spread,
                                       args.phone_jitter, identity=identity)
                if speaker_ll(spk, np.random.RandomState(1000 + i)) \
                        >= SPK_LL_GATE:
                    break
            seg_s = args.seconds / args.segments
            wav = np.concatenate([
                synth_ubm(spk, phones, seg_s, rng, session_spread=sess,
                          **style_kw)
                for _ in range(args.segments)])
            wavfile.write(os.path.join(args.outdir, f"spk_{i:03d}.wav"),
                          FS, wav)
        ident_txt = ("iid" if identity is None else
                     f"rank{args.identity_rank}/rho{args.identity_rho}"
                     f"/lseed{args.identity_seed}")
        print(f"wrote {args.speakers} UBM-ANCHORED {args.style} speakers "
              f"({args.keep_phones}/{args.phones} selected phones from "
              f"{args.ubm_path}, spread "
              f"{spread}/{args.session_spread}, identity {ident_txt}) "
              f"x {args.seconds}s to {args.outdir}")
        return
    if args.hard:
        protos = make_prototypes(rng, args.prototypes)
        for i in range(args.speakers):
            spk = make_hard_speaker(rng, protos, args.speaker_spread)
            seg_s = args.seconds / args.segments
            wav = np.concatenate([
                synth(spk, seg_s, rng, session_spread=args.session_spread,
                      snr_db=args.snr_db)
                for _ in range(args.segments)])
            wavfile.write(os.path.join(args.outdir, f"spk_{i:03d}.wav"),
                          FS, wav)
        print(f"wrote {args.speakers} HARD speakers "
              f"({args.prototypes} prototypes, spread "
              f"{args.speaker_spread}/{args.session_spread}, "
              f"{args.snr_db} dB SNR) x {args.seconds}s to {args.outdir}")
        return
    for i in range(args.speakers):
        spk = make_speaker(rng)
        wav = synth(spk, args.seconds, rng)
        wavfile.write(os.path.join(args.outdir, f"spk_{i:03d}.wav"), FS, wav)
    print(f"wrote {args.speakers} speakers x {args.seconds}s to {args.outdir}")


if __name__ == "__main__":
    main()
