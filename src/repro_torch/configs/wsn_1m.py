"""wsn-1m — the paper's own system at production scale.

1,048,576 virtual sensors (fleet telemetry channels) sharded over all chips,
banded covariance with half-width 128 after bandwidth reduction
(local covariance hypothesis), q=32 principal components, 256-epoch update
batches.  Not an LM architecture: consumed by the dry-run via
repro.core.production.

The fleet is two-level (DESIGN.md Sec. 13): ``n_regions`` regions of
``region_p`` sensors each stream independently and merge per refresh over
the cross-host ``region`` mesh axis.  :meth:`WSNConfig.smoke` is the
CI-sized replica of the same two-level shape — every ratio (band fraction,
q per region, regions per device) scaled down so the full pipeline runs
end-to-end in seconds on forced host devices.
"""
import dataclasses


@dataclasses.dataclass(frozen=True)
class WSNConfig:
    name: str = "wsn-1m"
    p: int = 1_048_576
    halfwidth: int = 128
    q: int = 32
    batch_epochs: int = 256
    n_regions: int = 1024
    dtype: str = "float32"

    @property
    def region_p(self) -> int:
        """Per-region sensor count of the two-level decomposition."""
        if self.p % self.n_regions != 0:
            raise ValueError(f"p={self.p} not divisible by "
                             f"n_regions={self.n_regions}")
        return self.p // self.n_regions

    def smoke(self) -> "WSNConfig":
        """CI-sized replica: same two-level shape, seconds not hours."""
        return dataclasses.replace(
            self, name="wsn-1m-smoke", p=4096, halfwidth=8, q=8,
            batch_epochs=8, n_regions=8)


CONFIG = WSNConfig()
