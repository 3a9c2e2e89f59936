"""A cell at a size a CPU test run holds: the configuration's widths,
small frames, batches and gallery."""

from __future__ import annotations

from perfbench import harness


def small(name: str) -> dict:
    """Serve: two 240 x 320 frames of four faces each, four slots, a
    64-row gallery. Train: 64 px images, 8 a step (4 a rank on several
    ranks)."""
    c = harness.cell(name)
    if c["traffic"]["driver"] == "train":
        per = 8 if c["traffic"].get("ranks", 1) == 1 else 4
        c["traffic"] = {**c["traffic"], "batch": per, "image": 64, "pool_batches": 3}
    else:
        c["traffic"] = {**c["traffic"], "batch": 2, "frame_hw": [240, 320], "faces_per_frame": 4,
                        "pool_batches": 2, "gallery_capacity": 64, "enrolled": 60,
                        "check_requests": 2, "warmup_requests": 3}
        c["config"] = {**c["config"], "detector": {**c["config"]["detector"], "max_faces": 4,
                                                   "k_pnet": 32, "k_rnet": 16}}
    return c
