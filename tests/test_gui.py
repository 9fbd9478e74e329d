"""Web GUI tests: drive the HTTP API surface end-to-end against a live
in-process server — noise → enroll → train → predict → conversation →
dump/load → users. Mirrors the flows of the reference PyQt4 GUI
(src/gui/gui.py: noise_clicked, do_enroll, start_train, reco_file,
do_conversation, dump/load, loadUsers/updateUserInfo)."""

import io
import json
import threading
import urllib.request
import wave

import numpy as np
import pytest

from speaker_recognition.config import GmmConfig, PipelineConfig
from speaker_recognition.api.interface import ModelInterface
from speaker_recognition.gui.server import GuiApp, decode_wav, make_server
from tests.test_endtoend import SPEAKER_FREQS, synth_utterance

FS = 8000


def wav_bytes(sig: np.ndarray, fs: int = FS) -> bytes:
    buf = io.BytesIO()
    with wave.open(buf, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(fs)
        w.writeframes(np.asarray(sig, np.int16).tobytes())
    return buf.getvalue()


def noise_clip(seed=0, seconds=1.0):
    rng = np.random.RandomState(seed)
    return (rng.randn(int(FS * seconds)) * 20).astype(np.int16)


@pytest.fixture(scope="module")
def server():
    cfg = PipelineConfig(gmm=GmmConfig(n_mixtures=4, n_iterations=50))
    app = GuiApp(model=ModelInterface(cfg))
    srv, _ = make_server(port=0, app=app)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{srv.server_address[1]}", app
    srv.shutdown()


def post(base, path, body=b"", raw=False):
    req = urllib.request.Request(base + path, data=body, method="POST")
    try:
        with urllib.request.urlopen(req) as r:
            return json.loads(r.read()), r.status
    except urllib.error.HTTPError as e:
        return json.loads(e.read()), e.code


def get(base, path):
    try:
        with urllib.request.urlopen(base + path) as r:
            return json.loads(r.read()), r.status
    except urllib.error.HTTPError as e:
        return json.loads(e.read()), e.code


class TestWavCodec:
    def test_decode_int16_mono(self):
        sig = (np.sin(np.arange(4000) / 10) * 1000).astype(np.int16)
        fs, out = decode_wav(wav_bytes(sig))
        assert fs == FS
        np.testing.assert_allclose(out, sig.astype(np.float64))

    def test_decode_stereo_averages(self):
        buf = io.BytesIO()
        left = np.full(100, 100, np.int16)
        right = np.full(100, 300, np.int16)
        inter = np.empty(200, np.int16)
        inter[0::2], inter[1::2] = left, right
        with wave.open(buf, "wb") as w:
            w.setnchannels(2); w.setsampwidth(2); w.setframerate(FS)
            w.writeframes(inter.tobytes())
        fs, out = decode_wav(buf.getvalue())
        np.testing.assert_allclose(out, np.full(100, 200.0))


class TestGuiFlow:
    """One module-scoped server; tests run in definition order and build the
    session up the way a user would."""

    def test_index_served(self, server):
        base, _ = server
        with urllib.request.urlopen(base + "/") as r:
            html = r.read().decode()
        assert "Conversation" in html and "/api/enroll" in html

    def test_initial_status(self, server):
        base, _ = server
        s, code = get(base, "/api/status")
        assert code == 200
        assert s["trained"] is False and s["speakers"] == []

    def test_predict_before_train_rejected(self, server):
        base, _ = server
        r, code = post(base, "/api/predict", wav_bytes(noise_clip()))
        assert code == 400 and "Not trained" in r["error"]

    def test_noise_and_enroll_and_train(self, server):
        base, _ = server
        r, code = post(base, "/api/noise", wav_bytes(noise_clip()))
        assert code == 200 and r["seconds"] == pytest.approx(1.0)

        r, code = post(base, "/api/enroll?name=", wav_bytes(noise_clip(1, 2.0)))
        assert code == 400  # gui.py:296-298 "Please Input Your Name"

        for i, name in enumerate(list(SPEAKER_FREQS)[:3]):
            sig = synth_utterance(name, 5.0, seed=20 + i)
            r, code = post(base, f"/api/enroll?name={name}", wav_bytes(sig))
            assert code == 200, r
            assert r["kept"] > 0
        r, code = post(base, "/api/train")
        assert code == 200 and len(r["speakers"]) == 3

        s, _ = get(base, "/api/status")
        assert s["trained"] is True and len(s["speakers"]) == 3

    def test_predict(self, server):
        base, _ = server
        for i, name in enumerate(list(SPEAKER_FREQS)[:3]):
            sig = synth_utterance(name, 3.0, seed=50 + i)
            r, code = post(base, "/api/predict", wav_bytes(sig))
            assert code == 200 and r["label"] == name, (r, name)
            # with VAD filtering, like reco_files (gui.py:260-267)
            r, code = post(base, "/api/predict?filter=1", wav_bytes(sig))
            assert code == 200 and r["label"] == name, (r, name)

    def test_conversation(self, server):
        base, _ = server
        names = list(SPEAKER_FREQS)[:2]
        r, code = post(base, "/api/conv/start?fs=8000")
        assert code == 200 and r["interval"] == pytest.approx(0.4)
        # stream 3 s of speaker A then 3 s of speaker B in 0.4 s chunks
        stream = np.concatenate([synth_utterance(names[0], 3.0, seed=70),
                                 synth_utterance(names[1], 3.0, seed=71)])
        chunk = int(0.4 * FS)
        labels = []
        for i in range(0, len(stream), chunk):
            pcm = stream[i:i + chunk].astype("<i2").tobytes()
            r, code = post(base, "/api/conv/feed", pcm)
            assert code == 200, r
            labels.append(r["label"])
        tl, _ = get(base, "/api/conv/timeline")
        shown = {e["label"] for e in tl["timeline"]}
        assert names[0] in shown and names[1] in shown, tl
        r, code = post(base, "/api/conv/stop")
        assert code == 200 and len(r["timeline"]) >= 2
        # session gone after stop
        tl, _ = get(base, "/api/conv/timeline")
        assert tl["timeline"] == []

    def test_dump_load_roundtrip(self, server, tmp_path_factory):
        base, app = server
        path = str(tmp_path_factory.mktemp("gui") / "session.out")
        r, code = post(base, "/api/dump", json.dumps({"path": path}).encode())
        assert code == 200
        r, code = post(base, "/api/load", json.dumps({"path": path}).encode())
        assert code == 200 and r["trained"] is True and len(r["speakers"]) == 3
        # loaded model predicts identically through the API
        name = list(SPEAKER_FREQS)[0]
        r, code = post(base, "/api/predict",
                       wav_bytes(synth_utterance(name, 3.0, seed=50)))
        assert code == 200 and r["label"] == name

    def test_users_metadata(self, server):
        base, _ = server
        users = [{"name": "alice", "age": 30, "sex": "F"}]
        r, code = post(base, "/api/users", json.dumps({"users": users}).encode())
        assert code == 200
        r, code = get(base, "/api/users")
        assert r["users"] == users
        r, code = post(base, "/api/users", json.dumps({"users": [{}]}).encode())
        assert code == 400

    def test_unknown_endpoint(self, server):
        base, _ = server
        r, code = post(base, "/api/nope")
        assert code == 400
        r, code = get(base, "/api/nope")
        assert code == 404
