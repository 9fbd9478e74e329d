#!/usr/bin/env python3
"""Per-speaker CRBM train/test driver — equivalent of the reference's nn
binary (src/nn/src/main.cc): read svm-format data (label = speaker id),
train one CRBM per speaker (the reference fans this out over 8 threads,
main.cc:500-518; here it is one vmapped program), classify test instances
by argmin reconstruction error (main.cc:453-465) and print accuracy
(overall_test, main.cc:547-553).

Usage:
  python -m speaker_recognition.tools.crbm_cli train -i train.svm -m bank.npz \
      --hidden 32 --epochs 100
  python -m speaker_recognition.tools.crbm_cli test -i test.svm -m bank.npz
"""

from __future__ import annotations

import argparse

import numpy as np


def _save_bank(path, labels, bank):
    np.savez(path, labels=np.asarray(labels),
             **{k: np.asarray(v) for k, v in bank._asdict().items()})


def main(argv=None):
    ap = argparse.ArgumentParser(description="CRBM speaker modeling")
    ap.add_argument("task", choices=["train", "test"])
    ap.add_argument("-i", "--input", required=True, help="svm-format data")
    ap.add_argument("-m", "--model", required=True, help="model npz file")
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--batch-size", type=int, default=100)
    ap.add_argument("--cd-k", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save-every", type=int, default=0, metavar="N",
                    help="checkpoint the model every N epochs during "
                    "training (the reference's nr_epoch_save, "
                    "crbm.cc:370-376); resumable and bit-identical to a "
                    "monolithic run")
    ap.add_argument("--text-dir", default=None, metavar="DIR",
                    help="also dump per-speaker models in the reference's "
                    "CRBM text format (crbm.cc:238-263) as "
                    "DIR/crbm.<label>.model")
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp
    from ..models import crbm
    from ..utils import datamanip

    X, y = datamanip.read_svm_data(args.input)
    labels = sorted(set(int(v) for v in y))

    if args.task == "train":
        groups = [X[y == l] for l in labels]
        n_max = max(len(g) for g in groups)
        S = len(labels)
        Xs = np.zeros((S, n_max, X.shape[1]), np.float32)
        masks = np.zeros((S, n_max), bool)
        for i, g in enumerate(groups):
            Xs[i, : len(g)] = g
            masks[i, : len(g)] = True
        cfg = crbm.CrbmTrainConfig(n_epochs=args.epochs,
                                   batch_size=args.batch_size,
                                   cd_k=args.cd_k)
        key = jax.random.PRNGKey(args.seed)
        if args.save_every > 0:
            state, done = None, 0
            while done < args.epochs:
                seg = min(args.save_every, args.epochs - done)
                state = crbm.fit_bank_segment(
                    jnp.asarray(Xs), jnp.asarray(masks), args.hidden, cfg,
                    key, state, seg, args.epochs)
                done += seg
                _save_bank(args.model, labels, state.params)
                print(f"checkpoint at epoch {done}/{args.epochs}")
            bank = state.params
        else:
            bank = crbm.fit_bank(jnp.asarray(Xs), jnp.asarray(masks),
                                 args.hidden, cfg, key)
        _save_bank(args.model, labels, bank)
        if args.text_dir:
            import os

            from ..utils import serialization

            os.makedirs(args.text_dir, exist_ok=True)
            for i, lbl in enumerate(labels):
                p = jax.tree.map(lambda v: np.asarray(v[i]), bank)
                with open(os.path.join(args.text_dir,
                                       f"crbm.{lbl}.model"), "w") as f:
                    serialization.dump_reference_crbm(p, f)
        print(f"trained {S} speaker CRBMs (nh={args.hidden}) on {len(X)} "
              f"instances")
    else:
        import os

        if os.path.isdir(args.model):
            # directory of reference-format text models: crbm.<label>.model
            import glob

            from ..utils import serialization

            model_labels, parts = [], []
            for p in sorted(glob.glob(os.path.join(args.model,
                                                   "crbm.*.model"))):
                model_labels.append(int(os.path.basename(p).split(".")[1]))
                with open(p) as f:
                    parts.append(serialization.load_reference_crbm(f))
            bank = crbm.CrbmParams(*[
                jnp.asarray(np.stack([np.asarray(getattr(q, fld), np.float32)
                                      for q in parts]))
                for fld in crbm.CrbmParams._fields])
        else:
            z = np.load(args.model if str(args.model).endswith(".npz")
                        else args.model + ".npz")
            bank = crbm.CrbmParams(**{k: jnp.asarray(z[k])
                                      for k in crbm.CrbmParams._fields})
            model_labels = [int(v) for v in z["labels"]]
        correct = 0
        for xi, yi in zip(X, y):
            errs = crbm.bank_reconstruction_errors(
                bank, jnp.asarray(xi[None, :], jnp.float32),
                jnp.ones(1, dtype=bool))
            pred = model_labels[int(np.argmin(np.asarray(errs)))]
            correct += pred == int(yi)
        print(f"accuracy: {correct}/{len(y)} = {correct / len(y):.4f}")


if __name__ == "__main__":
    main()
