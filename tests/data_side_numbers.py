"""The CPU measurements behind the data side's test bars, printed (not a test
module: pytest does not collect it).

    JAX_PLATFORMS=cpu python tests/data_side_numbers.py            # ~1 min
    JAX_PLATFORMS=cpu python tests/data_side_numbers.py --spread   # + ~5 min

  * ``crops``: the port's ``process_batch`` against JAX's on 4 photos
    (``face_frames(4, (120, 160), 1, rng(0))``, work size 160, 64 px
    crops): how far each chosen face moved, and the crops' level
    difference;
  * ``raw_tree``: the same per photo on the 18 JPEG photos of
    tests/test_torch_preprocess.py's raw tree, with O-Net's probability,
    and ``process_raw_data`` fed JAX's detections against JAX's files;
  * ``mining``: seconds of ``make_training_samples`` at 150 scenes per net;
  * ``--spread``: the mean IoU of tests/test_detector.py's training and
    bars over draws: JAX with ``hash()`` under PYTHONHASHSEED 0-3 and with
    the crc32 draw, the port at seed sets 0, 10, 20 and 30, and the port
    from JAX's initial weights.
"""

from __future__ import annotations

import io
import os
import subprocess
import sys
import tempfile
import time
import zlib
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))
WORK, FINAL = 160, (64, 64)


def _offsets(photos, jdet, jparams, tdet):
    import jax.numpy as jnp
    import torch

    import facerec_tpu.data.preprocess as jp

    x = np.stack([jp._letterbox(p, WORK)[0] for p in photos]).astype(np.float32)
    jd = jdet.detect(jparams, jnp.asarray(x))
    td = tdet.detect(torch.from_numpy(x))
    rows = []
    for i in range(len(photos)):
        jb = int(np.argmax(np.where(np.asarray(jd.valid[i]), np.asarray(jd.probs[i]), -1.0)))
        tb = int(torch.argmax(torch.where(td.valid[i], td.probs[i], -1.0)))
        off = max(np.abs(td.boxes[i, tb].numpy() - np.asarray(jd.boxes[i, jb])).max(),
                  np.abs(td.landmarks[i, tb].numpy() - np.asarray(jd.landmarks[i, jb])).max())
        rows.append((float(off), float(np.asarray(jd.probs[i, jb])), jb == tb))
    return rows


def crops_and_raw_tree() -> None:
    import jax.numpy as jnp
    import torch
    from PIL import Image

    import facerec_torch.data.preprocess as tp
    import facerec_tpu.data.preprocess as jp
    from facerec_torch.config import PreprocessingConfig
    from facerec_torch.data.synthetic import face_frames
    from facerec_torch.detect.mtcnn import Detections
    from facerec_torch.detect.weights import load_default_detector
    from facerec_tpu.config import PreprocessingConfig as JaxPreprocessingConfig
    from facerec_tpu.detect.weights import load_default_detector as jax_load

    torch.set_num_threads(1)
    jp.WORK_SIZE = tp.WORK_SIZE = WORK
    jdet, jparams = jax_load((WORK, WORK))
    tdet = load_default_detector((WORK, WORK), device="cpu")
    jc, tc = JaxPreprocessingConfig(final_size=FINAL), PreprocessingConfig(final_size=FINAL)

    photos = [f.astype(np.uint8) for f in face_frames(4, (120, 160), 1, np.random.default_rng(0))]
    ref = np.stack(jp.BatchPreprocessor(jc, jdet, jparams, batch_size=4).process_batch(photos))
    got = np.stack(tp.BatchPreprocessor(tc, tdet, batch_size=4, device="cpu").process_batch(photos))
    d = np.abs(got.astype(int) - ref.astype(int))
    offs = _offsets(photos, jdet, jparams, tdet)
    print(f"crops: 4 photos, faces moved max {max(o for o, _, _ in offs):.4f} px, "
          f"crop levels mean {d.mean():.4f} max {d.max()}")

    with tempfile.TemporaryDirectory() as td:
        raw = Path(td) / "raw"
        frames = face_frames(18, (120, 160), 1, np.random.default_rng(1)).astype(np.uint8)
        for i, f in enumerate(frames):
            q = raw / "ds0" / f"person_{i // 6}"
            q.mkdir(parents=True, exist_ok=True)
            Image.fromarray(f).save(q / f"img_{i % 6:02d}.jpg", quality=95)
        decoded = []
        for q in sorted(raw.rglob("*.jpg")):
            with Image.open(q) as im:
                decoded.append(np.asarray(im.convert("RGB"), np.uint8))
        for i, (off, prob, same) in enumerate(_offsets(decoded, jdet, jparams, tdet)):
            print(f"raw_tree photo {i:2d}: face moved {off:.4f} px at p {prob:.4f}"
                  f"{'' if same else ' (another face chosen)'}")

        class JaxBacked:
            def detect(self, chunk):
                out = jdet.detect(jparams, jnp.asarray(chunk.numpy()))
                return Detections(*(torch.from_numpy(np.array(a)) for a in out))

        a = jp.process_raw_data(raw, Path(td) / "jax", jc, detector=jdet, detector_params=jparams)
        b = tp.process_raw_data(raw, Path(td) / "port", tc, detector=JaxBacked(), device="cpu")
        names = sorted(str(q.relative_to(a)) for q in a.rglob("*.jpg") if "_aug" not in q.name)
        same, diffs = 0, []
        for n in names:
            x, y = (a / n).read_bytes(), (b / n).read_bytes()
            same += x == y
            diffs.append(np.abs(np.asarray(Image.open(io.BytesIO(x)), np.int32)
                                - np.asarray(Image.open(io.BytesIO(y)), np.int32)))
        d = np.stack(diffs)
        print(f"raw_tree with JAX's detections: {same} of {len(names)} split files byte-equal, "
              f"decoded levels mean {d.mean():.4f} max {d.max()}")


def mining() -> None:
    from facerec_torch.detect.train import make_training_samples

    for size, lm in ((12, False), (24, False), (48, True)):
        t0 = time.perf_counter()
        n = len(make_training_samples(150, size, 0, lm)["image"])
        print(f"mining: {size} px, 150 scenes, {n} samples in {time.perf_counter() - t0:.2f} s")


def one_run(kind: str, seed: int) -> tuple[float, int]:
    """(mean IoU, faces found of 16) of one training at
    tests/test_detector.py's configuration:
    ``jax`` (the renderer's ``hash()`` as the process has it), ``jaxcrc``
    (the port's crc32 draw), ``port`` (seed set seed, seed+1, seed+2) or
    ``portjax`` (the port from JAX's initial weights for seeds 0, 1, 2)."""
    import jax
    import jax.numpy as jnp
    import torch

    import facerec_tpu.data.synthetic as jsyn
    from facerec_tpu.detect import mtcnn as jm
    from facerec_tpu.detect import train as jt

    torch.set_num_threads(1)
    nets = (("pnet", 12, False), ("rnet", 24, False), ("onet", 48, True))
    rng = np.random.default_rng(77)
    if kind.startswith("jax"):
        if kind == "jaxcrc":
            jsyn.hash = lambda s: zlib.crc32(s.encode())
        jnets = {"pnet": jm.PNet, "rnet": jm.RNet, "onet": jm.ONet}
        params = {n: jt.train_net(jnets[n](), size, 150, 120, seed=i, with_landmarks=lm)
                  for i, (n, size, lm) in enumerate(nets)}
        det = jm.MTCNN((96, 96), min_face_size=24, thresholds=(0.6, 0.7, 0.7), max_faces=4,
                       k_pnet=32, k_rnet=16)
        scenes = [jsyn.render_scene(rng, canvas=96, face_size_range=(32, 72)) for _ in range(16)]
        out = det.detect(params, jnp.asarray(np.stack([s[0] for s in scenes]), jnp.float32))
        valid, probs, boxes = (np.asarray(a) for a in (out.valid, out.probs, out.boxes))
    else:
        from facerec_torch.data.synthetic import render_scene
        from facerec_torch.detect import mtcnn as tm
        from facerec_torch.detect.train import train_net

        params = {}
        for i, (n, size, lm) in enumerate(nets):
            cls = {"pnet": tm.PNet, "rnet": tm.RNet, "onet": tm.ONet}[n]
            init = None
            if kind == "portjax":
                jnet = {"pnet": jm.PNet, "rnet": jm.RNet, "onet": jm.ONet}[n]()
                init = jax.tree_util.tree_map(np.asarray, jnet.init(
                    jax.random.key(i), jnp.zeros((1, size, size, 3)))["params"])
            params[n] = train_net(cls(), size, 150, 120, seed=seed + i, with_landmarks=lm,
                                  init_params=init, device="cpu")
        det = tm.MTCNN((96, 96), min_face_size=24, thresholds=(0.6, 0.7, 0.7), max_faces=4,
                       k_pnet=32, k_rnet=16, device="cpu").load_jax_params(params)
        scenes = [render_scene(rng, canvas=96, face_size_range=(32, 72)) for _ in range(16)]
        out = det.detect(torch.from_numpy(np.stack([s[0] for s in scenes])).float())
        valid, probs, boxes = (a.numpy() for a in (out.valid, out.probs, out.boxes))
    ious = [jt._iou(boxes[i, int(np.argmax(probs[i] * valid[i]))], scenes[i][1])
            for i in range(16) if valid[i].any()]
    return float(np.mean(ious)) if ious else 0.0, len(ious)


def spread() -> None:
    runs = ([("jax", 0, str(h)) for h in range(4)] + [("jaxcrc", 0, "0")]
            + [("port", s, "0") for s in (0, 10, 20, 30)] + [("portjax", 0, "0")])
    procs = [(r, subprocess.Popen([sys.executable, __file__, "--one", r[0], str(r[1])],
                                  env={**os.environ, "PYTHONHASHSEED": r[2]},
                                  stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True))
             for r in runs]
    for (kind, seed, hs), p in procs:
        out, _ = p.communicate(timeout=1800)
        print(f"spread: {kind} seed {seed} PYTHONHASHSEED {hs}: {out.strip()}")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--one"]:
        iou, found = one_run(sys.argv[2], int(sys.argv[3]))
        print(f"found {found}/16, mean IoU {iou:.4f}")
    else:
        crops_and_raw_tree()
        mining()
        if "--spread" in sys.argv:
            spread()
