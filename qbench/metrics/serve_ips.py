"""Images answered in the window over the window's seconds (host clock): a
request's images count when its last image is answered before the close."""


def read(ctx):
    return float(ctx.requests["size"][ctx.answered].sum()) / ctx.seconds
