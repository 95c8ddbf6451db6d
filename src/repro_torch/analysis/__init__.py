"""Static plan analysis: the C2 budget footprints ``core.plan`` gates on."""
