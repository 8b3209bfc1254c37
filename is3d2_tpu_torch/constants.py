"""Physical constants (reference: src/cpp/iS3D.h:14-17)."""

import math

hbarC = 0.197327053  # GeV.fm
two_pi = 2.0 * math.pi
two_pi2_hbarC3 = 2.0 * math.pi**2 * hbarC**3
four_pi2_hbarC3 = 4.0 * math.pi**2 * hbarC**3
