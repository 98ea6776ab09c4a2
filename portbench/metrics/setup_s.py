"""setup_s: from the process's start to the first timed step: imports, the
kernels' build or load, the weights and AdamW state made on the card, and
the checked first steps that warm every shape."""


def read(record):
    return record.setup_s
