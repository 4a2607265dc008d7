"""Host-side ingestion: Criteo-TSV files on a multi-threaded C++ parser
(counterpart of ``rec_now_tpu/io/``; see ``criteo.py``)."""
from rec_now_tpu_torch.io.criteo import (CriteoTSV, fnv1a_mod, parse_chunk,
                                         write_synthetic_tsv)

__all__ = ["CriteoTSV", "fnv1a_mod", "parse_chunk",
           "write_synthetic_tsv"]
