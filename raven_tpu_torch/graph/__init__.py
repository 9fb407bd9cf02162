from raven_tpu_torch.graph.graph import Edge, Graph, Node  # noqa: F401
from raven_tpu_torch.graph.common import (  # noqa: F401
    create_unitigs,
    get_unitigs,
    remove_edges,
    unitig_record_name,
)
from raven_tpu_torch.graph.construct import construct_graph  # noqa: F401
from raven_tpu_torch.graph.assemble import assemble  # noqa: F401
from raven_tpu_torch.graph.binary import load_graph, store_graph  # noqa: F401
from raven_tpu_torch.graph.repr import (  # noqa: F401
    get_csv,
    get_gfa,
    load_gfa,
    print_csv,
    print_gfa,
    print_json,
    print_unitig_gfa,
)
