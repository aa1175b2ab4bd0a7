"""Host-side figures and HTML reports (numpy and matplotlib), ported from
``libtsd_tpu/viz``: they take tensors on any device.  matplotlib is the
optional ``viz`` extra; ``libtsd_tpu_torch`` does not import this package.
"""
from .figure import (Figure, Figures, cic_analyse,  # noqa: F401
                     plot_covariance_ellipse, plot_eye, plot_filter,
                     plot_plz)
from .report import Report, get_report  # noqa: F401
from .debug import debug_report, debug_figures  # noqa: F401
from .units import (calc_expo_ndigits, calc_expo_ndigits_common,  # noqa: F401
                    unit_format, si_tick_formatter)
