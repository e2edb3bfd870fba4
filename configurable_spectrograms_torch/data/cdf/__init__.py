"""Self-contained NASA CDF (Common Data Format) reader/writer.

The reference relies on the third-party ``cdflib`` package
(reference cdf_utils.py:10, pyproject.toml:21); this package has no such
dependency, so the subset of the CDF format needed for FAST ESA L2 files
(single-file CDF V2.6/2.7/3.x, z- and r-variables, uncompressed and
GZIP-compressed variable records, whole-file compression, global and
variable attributes) is implemented here from the public format
specification.  :class:`CDF` mirrors the small slice of the ``cdflib.CDF``
API the pipelines use (``varget``, context manager), so call sites read the
same as the reference's.
"""

from configurable_spectrograms_torch.data.cdf.reader import CDF, CDFError
from configurable_spectrograms_torch.data.cdf.writer import write_cdf

__all__ = ["CDF", "CDFError", "write_cdf"]
