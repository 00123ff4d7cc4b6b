"""DSP kernel library (SURVEY.md layer L2).

Pure-functional, jittable kernels: coefficient generators, block-FIR /
polyphase resampling with overlap-save state carry, the FM discriminator,
the PLL/NCO recurrence, and PSD estimation.
"""

from rtsdr_tpu.ops.channelizer import (  # noqa: F401
    channel_center_freqs,
    channelizer_taps,
    channelizer_zi,
    pfb_channelize,
)
from rtsdr_tpu.ops.coeffs import (  # noqa: F401
    bandpass_taps,
    lowpass_taps,
    rrc_taps,
)
from rtsdr_tpu.ops.demod import (  # noqa: F401
    fm_discriminator,
    fm_discriminator_linear,
)
from rtsdr_tpu.ops.fir import (  # noqa: F401
    fir_block,
    fir_decimate,
    fir_resample,
    fir_zi,
    resample_zi,
)
from rtsdr_tpu.ops.fourier import dft, magnitude  # noqa: F401
from rtsdr_tpu.ops.iir import deemphasize, first_order_iir  # noqa: F401
from rtsdr_tpu.ops.paths import choose  # noqa: F401
from rtsdr_tpu.ops.pll import PLLState, pll, pll_init  # noqa: F401
from rtsdr_tpu.ops.psd import estimate_psd  # noqa: F401
