"""The optimizer's iterations a plan: the mean of the last stage's
iteration count (the program's own ``n_iters``) over the traced solve's
plans. Moves the cell's rate: every iteration is an oracle pass and a
line search."""


def read(ctx):
    if "n_iters" not in ctx.answer:
        return None
    return float(ctx.answer["n_iters"].mean())
