"""Streamlit UI for the live demo (counterpart of ``facerec_tpu/serve/app_ui.py``;
reference src/app.py:267-731 main()).

Sidebar tabs Controls / Faces / History, webcam start/stop, box and label
overlay, add/rename/delete reference faces, and the prompt for an unknown
face. Launched by ``python -m facerec_torch.cli.main demo`` (``serve/app.py``
``run_demo``), which runs

    python -m streamlit run facerec_torch/serve/app_ui.py [-- --device cpu]

The overlay needs no OpenCV: the box outline is drawn in numpy, pixel for
pixel what ``cv2.rectangle(img, p1, p2, color, 2)`` draws, and the label
with Pillow.
"""

from __future__ import annotations

import argparse
import queue
import time

import numpy as np
import streamlit as st

from facerec_torch.config import ServeConfig
from facerec_torch.serve.app import FaceDemo, build_default_pipeline, synthetic_frame_source


def _device() -> str | None:
    """``--device`` after the script's ``--`` (default: the CUDA card)."""
    ap = argparse.ArgumentParser(prog="app_ui.py")
    ap.add_argument("--device", default=None)
    return ap.parse_known_args()[0].device


@st.cache_resource
def _load_demo(use_synthetic: bool):
    cfg = ServeConfig()
    pipe = build_default_pipeline(config=cfg, device=_device())
    source = synthetic_frame_source(pipe.frame_hw) if use_synthetic else None
    return FaceDemo(pipe, cfg, frame_source=source)


def draw_box(img: np.ndarray, box, color) -> None:
    """``cv2.rectangle(img, (x1, y1), (x2, y2), color, 2)`` in place: each
    side a band three pixels wide centred on the edge, the corners' outer
    pixel left out, clipped to the image."""
    h, w = img.shape[:2]
    x1, y1, x2, y2 = (int(v) for v in box)
    xa, xb = sorted((x1, x2))
    ya, yb = sorted((y1, y2))

    def fill(r0: int, r1: int, c0: int, c1: int) -> None:  # inclusive bounds
        r0, c0, r1, c1 = max(r0, 0), max(c0, 0), min(r1, h - 1), min(c1, w - 1)
        if r0 <= r1 and c0 <= c1:
            img[r0:r1 + 1, c0:c1 + 1] = color

    for y in (ya, yb):
        fill(y - 1, y + 1, xa, xb)
    for x in (xa, xb):
        fill(ya, yb, x - 1, x + 1)


def _draw(frame: np.ndarray, faces: list[dict]) -> np.ndarray:
    """The frame with each face's box (green when known) and, above it, its
    name and distance (labels drawn after every box)."""
    from PIL import Image, ImageDraw, ImageFont

    img = frame.copy()
    labels = []
    for f in faces:
        x1, y1, x2, y2 = [int(v) for v in f["box"]]
        known = f["name"] != "Unknown"
        color = (0, 255, 0) if known else (255, 80, 80)
        draw_box(img, (x1, y1, x2, y2), color)
        label = f"{f['name']} ({f['distance']:.2f})" if known else "Unknown"
        labels.append(((x1, max(y1 - 8, 12)), label, color))
    if not labels:
        return img
    pil = Image.fromarray(img)
    pen = ImageDraw.Draw(pil)
    font = ImageFont.load_default()
    for xy, label, color in labels:
        pen.text(xy, label, fill=color, font=font, anchor="ls")
    return np.asarray(pil)


def main() -> None:
    st.set_page_config(page_title="Face Recognition (CUDA)", layout="wide")
    st.title("Real-time Face Recognition — CUDA pipeline")
    use_synthetic = st.sidebar.checkbox("Synthetic camera (no webcam)", value=False)
    demo = _load_demo(use_synthetic)

    tab_controls, tab_faces, tab_history = st.sidebar.tabs(["Controls", "Faces", "History"])
    with tab_controls:
        if st.button("Start" if demo._thread is None else "Restart"):
            demo.stop()
            demo.start()
        if st.button("Stop"):
            demo.stop()
        st.metric("gallery size", demo.pipeline.gallery.count)
    with tab_faces:
        for name in list(demo.pipeline.gallery.names):
            c1, c2, c3 = st.columns([3, 1, 1])
            c1.write(name)
            new = c2.text_input("rename", key=f"rn_{name}", label_visibility="collapsed")
            if new and c2.button("ok", key=f"rok_{name}"):
                demo.pipeline.gallery.rename(name, new)
                demo.pipeline.gallery.save()
            if c3.button("x", key=f"del_{name}"):
                demo.remove_reference(name)
        if st.button("Clear all references"):
            demo.pipeline.gallery.clear()
            demo.pipeline.gallery.save()
    with tab_history:
        for h in demo.history[-50:][::-1]:
            st.write(f"{h['time']} — {h['name']} ({h['distance']:.2f})")

    # The unknown-face capture lives in demo.capture (armed by the processing
    # loop), not in per-frame widgets: the form is built once per script run
    # with stable keys, so typing a name survives the reruns that any widget
    # interaction triggers (demo itself persists through st.cache_resource).
    cap = demo.capture
    if cap.pending is not None:
        with st.container():
            c_img, c_form = st.columns([1, 3])
            if cap.pending["crop"].size:
                c_img.image(cap.pending["crop"], caption="Unknown face", width=120)
            name = c_form.text_input("Unknown face detected — name to add:",
                                     key="unknown_name")
            c1, c2 = c_form.columns(2)
            if c1.button("Add reference", key="unknown_add") and name:
                if cap.name(name):
                    st.success(f"added {name}")
                    # an empty field for the next stranger (a widget's key
                    # cannot be assigned once it exists: pop, then rerun)
                    st.session_state.pop("unknown_name", None)
                    st.rerun()
            if c2.button("Dismiss", key="unknown_dismiss"):
                cap.dismiss()
                st.session_state.pop("unknown_name", None)
                st.rerun()

    placeholder = st.empty()
    pending_note = st.empty()
    while demo._thread is not None and demo._thread.is_alive():
        try:
            frame, faces = demo.result_q.get(timeout=0.2)
        except queue.Empty:
            time.sleep(0.05)
            continue
        placeholder.image(_draw(frame, faces), channels="RGB")
        if cap.pending is not None:
            pending_note.info("Unknown face captured — use the form above to "
                              "name it (any interaction refreshes the app).")
        else:
            pending_note.empty()


if __name__ == "__main__":
    main()
