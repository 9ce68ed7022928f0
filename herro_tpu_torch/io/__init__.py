from .fastx import ReadSet, load_reads, read_cluster, list_read_files
from .seqstore import PackedSeqs, encode, decode
from .fasta import write_corrected

__all__ = [
    "ReadSet",
    "load_reads",
    "read_cluster",
    "list_read_files",
    "PackedSeqs",
    "encode",
    "decode",
    "write_corrected",
]
