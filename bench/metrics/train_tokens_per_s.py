"""train_tokens_per_s: the tokens of every step that completed in the
window (its loss on the host), over the window's seconds."""


def read(rec):
    if "steps" not in rec:
        return None
    span = rec["window_end"] - rec["window_start"]
    return len(rec["steps"]) * rec["tokens_per_step"] / span
