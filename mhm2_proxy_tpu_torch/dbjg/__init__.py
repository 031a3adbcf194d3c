from .traverse import traverse_debruijn_graph, build_edges  # noqa: F401
from .traverse_sharded import traverse_debruijn_graph_sharded  # noqa: F401
