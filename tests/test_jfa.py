"""JFA parity tests: batched JAX vs literal numpy transcriptions of the
reference MATLAB (src/jfa/estimate_{x_and_u,y_and_v,z_and_d}.m,
linear_scoring.m)."""

import numpy as np
import jax
import jax.numpy as jnp

from speaker_recognition.models import gmm, jfa


def setup(K=3, dim=4, nu=2, nv=3, n_spk=3, n_sessions=7, seed=0):
    rng = np.random.RandomState(seed)
    D = K * dim
    m = rng.randn(D)
    E = 0.5 + rng.rand(D)
    u = rng.randn(nu, D) * 0.1
    v = rng.randn(nv, D) * 0.1
    d = rng.rand(D) * 0.1
    y = rng.randn(n_spk, nv) * 0.5
    z = rng.randn(n_spk, D) * 0.2
    x = rng.randn(n_sessions, nu) * 0.5
    spk_ids = rng.randint(0, n_spk, n_sessions)
    spk_ids[:n_spk] = np.arange(n_spk)  # every speaker has a session
    N = rng.rand(n_sessions, K) * 50 + 5
    F = rng.randn(n_sessions, D) * 10
    return dict(K=K, dim=dim, D=D, m=m, E=E, u=u, v=v, d=d, y=y, z=z, x=x,
                spk_ids=spk_ids, N=N, F=F, n_spk=n_spk)


def expand(N, dim):
    return np.repeat(N, dim, axis=-1)


def oracle_estimate_x(p):
    """Literal loop transcription of estimate_x_and_u.m:88-126."""
    K, dim, D = p["K"], p["dim"], p["D"]
    nu = p["u"].shape[0]
    uEuT = []
    for c in range(K):
        sl = slice(c * dim, (c + 1) * dim)
        uc = p["u"][:, sl]
        uEuT.append((uc / p["E"][sl][None, :]) @ uc.T)
    S = len(p["spk_ids"])
    x = np.zeros((S, nu))
    A = [np.zeros((nu, nu)) for _ in range(K)]
    C = np.zeros((nu, D))
    for j in range(S):
        ii = p["spk_ids"][j]
        spk_shift = p["m"] + p["y"][ii] @ p["v"] + p["z"][ii] * p["d"]
        Nh = expand(p["N"][j], dim)
        Fh = p["F"][j] - Nh * spk_shift
        L = np.eye(nu)
        for c in range(K):
            L = L + uEuT[c] * p["N"][j, c]
        invL = np.linalg.inv(L)
        x[j] = ((Fh / p["E"]) @ p["u"].T) @ invL
        P = invL + np.outer(x[j], x[j])
        for c in range(K):
            A[c] += P * p["N"][j, c]
        C += np.outer(x[j], Fh)
    return x, np.stack(A), C


def oracle_estimate_y(p):
    """Literal transcription of estimate_y_and_v.m:83-129."""
    K, dim, D = p["K"], p["dim"], p["D"]
    nv = p["v"].shape[0]
    vEvT = []
    for c in range(K):
        sl = slice(c * dim, (c + 1) * dim)
        vc = p["v"][:, sl]
        vEvT.append((vc / p["E"][sl][None, :]) @ vc.T)
    y = np.zeros((p["n_spk"], nv))
    A = [np.zeros((nv, nv)) for _ in range(K)]
    C = np.zeros((nv, D))
    for ii in range(p["n_spk"]):
        sess = np.nonzero(p["spk_ids"] == ii)[0]
        Fs = p["F"][sess].sum(axis=0)
        Nss = p["N"][sess].sum(axis=0)
        Ns = expand(Nss, dim)
        Fs = Fs - (p["m"] + p["z"][ii] * p["d"]) * Ns
        for j in sess:
            Fs = Fs - (p["x"][j] @ p["u"]) * expand(p["N"][j], dim)
        L = np.eye(nv)
        for c in range(K):
            L = L + vEvT[c] * Nss[c]
        invL = np.linalg.inv(L)
        y[ii] = ((Fs / p["E"]) @ p["v"].T) @ invL
        P = invL + np.outer(y[ii], y[ii])
        for c in range(K):
            A[c] += P * Nss[c]
        C += np.outer(y[ii], Fs)
    return y, np.stack(A), C


def oracle_estimate_z(p):
    """Literal transcription of estimate_z_and_d.m:80-106."""
    dim = p["dim"]
    z = np.zeros((p["n_spk"], p["D"]))
    a = np.zeros(p["D"])
    b = np.zeros(p["D"])
    for ii in range(p["n_spk"]):
        sess = np.nonzero(p["spk_ids"] == ii)[0]
        Fs = p["F"][sess].sum(axis=0)
        Ns = expand(p["N"][sess], dim).sum(axis=0)
        Fs = Fs - (p["m"] + p["y"][ii] @ p["v"]) * Ns
        for j in sess:
            Fs = Fs - (p["x"][j] @ p["u"]) * expand(p["N"][j], dim)
        L = 1.0 + Ns / p["E"] * p["d"] ** 2
        z[ii] = Fs / p["E"] * p["d"] / L
        a += (1.0 / L + z[ii] ** 2) * Ns
        b += z[ii] * Fs
    return z, a, b


def hyper_of(p):
    return jfa.JfaHyper(m=jnp.asarray(p["m"]), E=jnp.asarray(p["E"]),
                        v=jnp.asarray(p["v"]), u=jnp.asarray(p["u"]),
                        d=jnp.asarray(p["d"]))


class TestEstimators:
    def test_estimate_x_matches_oracle(self):
        p = setup()
        x_ref, A_ref, C_ref = oracle_estimate_x(p)
        x, A, C = jfa.estimate_x(jnp.asarray(p["F"]), jnp.asarray(p["N"]),
                                 hyper_of(p), jnp.asarray(p["y"]),
                                 jnp.asarray(p["z"]), jnp.asarray(p["spk_ids"]),
                                 p["K"])
        np.testing.assert_allclose(np.asarray(x), x_ref, rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(np.asarray(A), A_ref, rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(np.asarray(C), C_ref, rtol=1e-8, atol=1e-8)

    def test_estimate_y_matches_oracle(self):
        p = setup(seed=1)
        y_ref, A_ref, C_ref = oracle_estimate_y(p)
        y, A, C = jfa.estimate_y(jnp.asarray(p["F"]), jnp.asarray(p["N"]),
                                 hyper_of(p), jnp.asarray(p["x"]),
                                 jnp.asarray(p["z"]), jnp.asarray(p["spk_ids"]),
                                 p["K"], p["n_spk"])
        np.testing.assert_allclose(np.asarray(y), y_ref, rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(np.asarray(A), A_ref, rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(np.asarray(C), C_ref, rtol=1e-8, atol=1e-8)

    def test_estimate_z_matches_oracle(self):
        p = setup(seed=2)
        z_ref, a_ref, b_ref = oracle_estimate_z(p)
        z, a, b = jfa.estimate_z(jnp.asarray(p["F"]), jnp.asarray(p["N"]),
                                 hyper_of(p), jnp.asarray(p["x"]),
                                 jnp.asarray(p["y"]), jnp.asarray(p["spk_ids"]),
                                 p["K"], p["n_spk"])
        np.testing.assert_allclose(np.asarray(z), z_ref, rtol=1e-8, atol=1e-10)
        np.testing.assert_allclose(np.asarray(a), a_ref, rtol=1e-8, atol=1e-8)
        np.testing.assert_allclose(np.asarray(b), b_ref, rtol=1e-8, atol=1e-8)

    def test_update_u_matches_per_component_solve(self):
        p = setup(seed=3)
        _, A, C = oracle_estimate_x(p)
        ref = np.zeros_like(C)
        dim = p["dim"]
        for c in range(p["K"]):
            sl = slice(c * dim, (c + 1) * dim)
            ref[:, sl] = np.linalg.solve(A[c], C[:, sl])
        out = jfa.update_u(jnp.asarray(A), jnp.asarray(C))
        np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-8, atol=1e-10)

    def test_accumulators_are_associative(self):
        """Stats from two session shards sum to the full-batch stats — the
        property that makes the psum sharding exact."""
        p = setup(n_sessions=8, seed=4)
        x_full, A_full, C_full = oracle_estimate_x(p)
        # split sessions 0..3 / 4..7 (speakers not split: construct ids so)
        p["spk_ids"] = np.array([0, 0, 1, 1, 2, 2, 2, 1])
        x_full, A_full, C_full = oracle_estimate_x(p)
        A_sum = np.zeros_like(A_full)
        C_sum = np.zeros_like(C_full)
        for sl in (slice(0, 4), slice(4, 8)):
            q = dict(p)
            q["F"], q["N"], q["spk_ids"] = p["F"][sl], p["N"][sl], p["spk_ids"][sl]
            _, A_part, C_part = oracle_estimate_x(q)
            A_sum += A_part
            C_sum += C_part
        np.testing.assert_allclose(A_sum, A_full, rtol=1e-9)
        np.testing.assert_allclose(C_sum, C_full, rtol=1e-9)


class TestScoring:
    def test_linear_scores_match_oracle(self):
        p = setup(seed=5)
        K, dim = p["K"], p["dim"]
        # oracle: linear_scoring.m:50-71
        M = (p["z"] * p["d"][None, :] + p["y"] @ p["v"]) / p["E"][None, :]
        chan = (p["m"][None, :] + p["x"] @ p["u"]) * expand(p["N"], dim)
        Fc = (p["F"] - chan) / p["N"].sum(axis=1, keepdims=True)
        ref = M @ Fc.T
        out = jfa.linear_scores(jnp.asarray(p["F"]), jnp.asarray(p["N"]),
                                hyper_of(p), jnp.asarray(p["y"]),
                                jnp.asarray(p["z"]), jnp.asarray(p["x"]), K)
        np.testing.assert_allclose(np.asarray(out), ref, rtol=1e-8, atol=1e-10)


class TestTrainingLoop:
    def test_v_training_reduces_reconstruction(self):
        """Eigenvoice EM should explain speaker variation: after training,
        scoring same-speaker stats should beat cross-speaker."""
        rng = np.random.RandomState(6)
        K, dim, n_spk, sessions_per = 2, 3, 3, 4
        D = K * dim
        ubm = gmm.GmmParams(
            jnp.asarray(np.full(K, 1.0 / K)),
            jnp.asarray(rng.randn(K, dim) * 2),
            jnp.asarray(0.5 + rng.rand(K, dim)))
        m = np.asarray(ubm.means).reshape(-1)
        E = np.asarray(ubm.sigmas).reshape(-1) ** 2
        spk_offset = rng.randn(n_spk, dim) * 1.0

        Ns, Fs, ids = [], [], []
        for s in range(n_spk):
            for _ in range(sessions_per):
                comps = rng.randint(0, K, 200)
                Xd = (np.asarray(ubm.means)[comps] + spk_offset[s]
                      + rng.randn(200, dim) * np.asarray(ubm.sigmas)[comps])
                N_, F_ = jfa.collect_stats(ubm, jnp.asarray(Xd),
                                           jnp.ones(200, dtype=bool))
                Ns.append(np.asarray(N_))
                Fs.append(np.asarray(F_))
                ids.append(s)
        N = jnp.asarray(np.stack(Ns))
        F = jnp.asarray(np.stack(Fs))
        ids = jnp.asarray(np.array(ids))

        v, y = jfa.train_v(F, N, jnp.asarray(m), jnp.asarray(E), nv=2,
                           spk_ids=ids, n_components=K, n_iter=10)
        assert np.isfinite(np.asarray(v)).all()
        # speaker factors should separate the speakers
        y = np.asarray(y)
        d01 = np.linalg.norm(y[0] - y[1])
        assert d01 > 1e-3
