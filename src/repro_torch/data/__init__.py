from repro_torch.data.loader import ClientDataset, build_client_datasets
from repro_torch.data.partition import ClientShard, dirichlet_partition
from repro_torch.data.synthetic import synthetic_femnist

__all__ = ["ClientDataset", "ClientShard", "build_client_datasets",
           "dirichlet_partition", "synthetic_femnist"]
