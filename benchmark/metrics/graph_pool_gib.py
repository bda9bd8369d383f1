"""GiB the CUDA graph's capture reserved (``GraphedStep.pool_bytes``); none
when the Trainer runs the eager loop."""


def read(ctx):
    graph = getattr(ctx.trainer, "_graph", None)
    return graph.pool_bytes / 2 ** 30 if graph is not None and graph.pool_bytes else None
