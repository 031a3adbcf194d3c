from .traverse import traverse_debruijn_graph, build_edges  # noqa: F401
