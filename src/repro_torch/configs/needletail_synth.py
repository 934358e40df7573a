"""Paper-native config: the NeedleTail synthetic workload itself (§7.1) —
100M-record table, 8 binary dims, 2 measures, 256KB-equivalent blocks.
Used by the data-engine benchmarks and the paper-technique dry-run cell."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class NeedleTailConfig:
    num_records: int = 100_000_000
    num_dims: int = 8
    num_measures: int = 2
    density: float = 0.10
    records_per_block: int = 8192  # ~256KB blocks at 32B/record
    block_bytes: int = 256 * 1024


CONFIG = NeedleTailConfig()
