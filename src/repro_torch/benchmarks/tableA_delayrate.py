"""Paper Appendix A: delay-rate model — FFT and stencil worked examples.
Each row's derived field shows the paper's quoted value; the us_per_call
column is the computed gamma (us/MB) or eta (dimensionless).  Closed
forms only: no fabric runs, so ``engine`` and ``device`` are unused."""

from ..core import perfmodel as pm
from .common import DEVICE, ENGINE, module_main


def rows(engine: str = ENGINE, device=DEVICE):
    out = []
    for theta, paper in [(1, 7.1428), (2, 187.1936), (8, 1263.67)]:
        out.append((f"tableA/fft/gamma_theta{theta}", pm.FFT.gamma(theta),
                    f"paper={paper}"))
    for theta, paper in [(1, 1.0228), (2, 1.4134), (8, 1.9748)]:
        out.append((f"tableA/fft/eta_theta{theta}",
                    pm.FFT.eta(8, theta, 25e9), f"paper={paper}"))
    for theta, paper in [(1, 15.3398), (2, 46.92385), (8, 228.21311)]:
        out.append((f"tableA/stencil/gamma_theta{theta}",
                    pm.STENCIL.gamma(theta), f"paper={paper}"))
    for theta, paper in [(1, 1.1060), (2, 1.1718), (8, 1.2169)]:
        out.append((f"tableA/stencil/eta_theta{theta}",
                    pm.STENCIL.eta(8, theta, pm.STENCIL_EXAMPLE_BETA),
                    f"paper={paper} (beta=50GB/s, see DESIGN.md)"))
    for gamma, paper in [(1.0, 1.003), (10.0, 1.032)]:
        out.append((f"tableA/s221/eta_gamma{gamma}",
                    pm.eta_large(8, 1, gamma, 25e9), f"paper={paper}"))
    out.append(("tableA/s221/eta_theta8_gamma1000",
                pm.eta_large(8, 8, 1000.0, 25e9), "paper=1.641"))
    return out


if __name__ == "__main__":
    import sys
    module_main(sys.modules[__name__])
