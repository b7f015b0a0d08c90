"""Copy of ``repro.sensors`` for the PyTorch port
(held equal to it by tests/test_torch_streaming.py).
"""

from repro_torch.sensors.dataset import (SensorDataset, berkeley_surrogate,
                                        kfold_blocks)

__all__ = ["SensorDataset", "berkeley_surrogate", "kfold_blocks"]
