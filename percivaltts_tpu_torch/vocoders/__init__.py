from percivaltts_tpu_torch.vocoders.base import Vocoder, get_vocoder  # noqa: F401
from percivaltts_tpu_torch.vocoders.pml import PMLVocoder  # noqa: F401
