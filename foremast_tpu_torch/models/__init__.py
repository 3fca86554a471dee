"""Fitted-model state kept between ticks (the bounded fit cache), and the
seasonal models beyond the core forecasters.

Importing this package registers the seasonal (Prophet-substitute) model
into the engine's `AI_MODEL` registry as `seasonal`, `prophet` and the
hourly variant `seasonal_hourly` (period 60, order 2), as the JAX
package's `models/__init__.py` does; `scoring._fit_model` imports it
when it meets a name it does not know yet.
"""

from functools import partial

from foremast_tpu_torch.engine.scoring import register_model
from foremast_tpu_torch.models.seasonal import fit_seasonal

register_model("seasonal", fit_seasonal)
register_model("prophet", fit_seasonal)  # documented substitution, see seasonal.py
# hourly seasonality variant (60 steps at the 60 s PromQL step)
register_model("seasonal_hourly", partial(fit_seasonal, period=60, order=2))


def lstm_ae_shardings(mesh, params, opt_state):
    """`lstm_ae.shardings` at the detector's hidden width (the JAX
    package's `models.lstm_ae_shardings`)."""
    from foremast_tpu_torch.models.lstm_ae import LSTMAEConfig, shardings

    return shardings(mesh, params, opt_state, LSTMAEConfig().hidden)
