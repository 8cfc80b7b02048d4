"""`setup_s` (s, host clock): from the start of the command to the start
of the window: imports, the card, the kernels' library (built in a new
checkout), the inputs, the program's set-up and the warm-up calls."""


def read(ctx):
    return ctx.window["setup_s"]
