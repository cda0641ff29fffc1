"""Seconds of set-up spent in the first call of each built module at each
argument signature: the sum of the port's ``compile`` spans (host time of
the call, cuDNN's plan choice, a kernel's first launch and the cost
ledger's capture inside it) that end before the window starts. K2's
``nvcc`` build, on a checkout's first run, falls in the model build before
them, so the reading does not depend on the order of runs. The run's context
holds only the window's spans, so this reads the set-up rows from the
program's process-current telemetry
(``video_features_tpu_torch.runtime.telemetry.current().spans()``, the
extractor's module-level sink). None where the program records no such
span."""

LAYER = "set-up: first call at each signature"
UNIT = "s"
BETTER = "lower"
SOURCE = "program_span"
MOVES = "setup_s"


def read(ctx):
    from video_features_tpu_torch.runtime import telemetry

    tele = telemetry.current()
    if tele is None:
        return None
    t_start = ctx["window"]["t_start"]
    spans = [r["t1"] - r["t0"] for r in tele.spans()
             if r.get("stage") == "compile" and r.get("t1", t_start) < t_start]
    return sum(spans) if spans else None
