"""BraggNN (the paper's case-study DNN, Listing 5) as a selectable config.

The OpenHLS deployment target:
Bragg-diffraction-peak characterisation at 1 MHz sampling (goal 1 us/sample;
paper achieves 4.8 us/sample on an Alveo U280 at FloPoCo (5,3) precision).
"""

import dataclasses


@dataclasses.dataclass(frozen=True)
class BraggNNConfig:
    name: str = "braggnn"
    family: str = "cnn"
    scale: int = 1                 # the paper's s parameter
    img: int = 11                  # input patch side
    quant_format: str = "5_4"      # FloPoCo format for deployment
    taylor_order: int = 8          # exp expansion order (softmax)
    pipeline_stages: int = 3       # paper §4.2 deployment


CONFIG = BraggNNConfig()


def tiny() -> BraggNNConfig:
    return dataclasses.replace(CONFIG, name="braggnn-tiny", img=7)
