"""Optical depth and TUD products (counterpart of
``radtxfr_tpu/products``; ``make_tud_fn`` is the port's fused composition,
the counterpart of ``make_tud_pallas_fn``)."""

from .od import compute_od_layers, compute_od_layer, species_column  # noqa: F401
from .tud import (TUD, tud_from_od, make_tud_fn,  # noqa: F401
                  downwelling_angles, downwelling_quadrature)
from .radiance import apparent_radiance  # noqa: F401
