"""train_tokens_per_s: the tokens of every optimizer step of the window,
over the window's seconds (host clock; each step ends in a device sync)."""


def read(record):
    if not record.steps or record.window_s <= 0:
        return None
    return len(record.steps) * record.tokens_per_step / record.window_s
