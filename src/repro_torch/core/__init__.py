"""Core library: formats, reordering, clustering and the gather/scatter
SpGEMM tier of the port, with the paper's work counters."""
from repro_torch.core.formats import (BCC, CSR, CSRCluster, HostCSR,
                                      bcc_from_host, csr_cluster_from_host,
                                      csr_cluster_nbytes_exact,
                                      csr_from_host, csr_nbytes)
from repro_torch.core.clustering import (Clustering, DEFAULT_JACC_TH,
                                         DEFAULT_MAX_CLUSTER,
                                         fixed_length_clusters,
                                         hierarchical_clusters,
                                         variable_length_clusters)
from repro_torch.core.reorder import REORDERINGS, reorder
from repro_torch.core.spgemm import (b_bytes_rowwise_binned, b_bytes_tiled,
                                     flops_spgemm, gathers_clusterwise,
                                     gathers_rowwise,
                                     spgemm_clusterwise_dense,
                                     spgemm_reference, spgemm_rowwise_dense,
                                     spmm_clusterwise, spmm_rowwise,
                                     symbolic_nnz, symbolic_row_nnz)

__all__ = [
    "BCC", "CSR", "CSRCluster", "HostCSR", "bcc_from_host",
    "csr_cluster_from_host", "csr_cluster_nbytes_exact", "csr_from_host",
    "csr_nbytes", "Clustering", "DEFAULT_JACC_TH", "DEFAULT_MAX_CLUSTER",
    "fixed_length_clusters", "hierarchical_clusters",
    "variable_length_clusters", "REORDERINGS", "reorder", "flops_spgemm",
    "spgemm_clusterwise_dense", "spgemm_reference", "spgemm_rowwise_dense",
    "spmm_clusterwise", "spmm_rowwise", "symbolic_nnz", "symbolic_row_nnz",
    "gathers_rowwise", "gathers_clusterwise", "b_bytes_rowwise_binned",
    "b_bytes_tiled",
]
