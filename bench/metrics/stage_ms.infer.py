"""The infer stage's median milliseconds a frame
(`StreamingPipeline.stats()["stage"]`)."""


def read(rec):
    if rec["kind"] != "sweep":
        return None
    return rec["stage_p50_ms"].get("infer")
