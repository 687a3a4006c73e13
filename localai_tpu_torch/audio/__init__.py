"""Audio utilities: WAV I/O, resampling, mel features, VAD
(localai_tpu/audio/).

Feature extraction (log-mel) runs on tensors, on the card unless the
caller passes CPU tensors; WAV I/O and resampling are stdlib `wave`, numpy
and scipy on the host.
"""

from localai_tpu_torch.audio.wav import read_wav, resample, write_wav  # noqa: F401
from localai_tpu_torch.audio.features import log_mel_spectrogram, mel_filterbank  # noqa: F401
from localai_tpu_torch.audio.vad import energy_vad  # noqa: F401
