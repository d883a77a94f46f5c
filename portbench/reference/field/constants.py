"""Units of the reference field: kpc, km/s, Msun (time kpc/(km/s))."""

#: Gravitational constant in (kpc, km/s, Msun) units.
G_DEFAULT: float = 4.300917270069976e-06
