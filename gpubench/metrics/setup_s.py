"""setup_s (s): process start to the window's start -- imports, the
kernel libraries, the inputs made on the card, planning, one warm-up
query.  Host clock."""


def read(run):
    return run.setup_s
