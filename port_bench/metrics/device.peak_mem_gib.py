"""GiB of ``torch.cuda.max_memory_allocated`` over the window, after
``reset_peak_memory_stats`` at its start: memory bounds ``--batch_size``
and ``--video_batch``, and so the rate."""

LAYER = "device: the card"
UNIT = "GiB"
BETTER = "lower"
SOURCE = "program_counter"
MOVES = "videos_per_s"


def read(ctx):
    peak = ctx["peak_window_bytes"]
    return peak / 2 ** 30 if peak else None
