"""The six project rules. Importing this package registers them all
(each module calls ``core.register`` at import)."""

from edl_tpu_torch.analysis.rules import (  # noqa: F401
    donation,
    kvblock,
    lockset,
    recompile,
    silentfail,
    telemetry,
)
