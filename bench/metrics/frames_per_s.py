"""Frames whose detections were delivered by the window's close, over the
window's seconds."""


def read(rec):
    if rec["kind"] != "sweep" or not rec["frames_done"]:
        return None
    return rec["frames_done"] / rec["seconds"]
