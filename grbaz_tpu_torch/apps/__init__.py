"""Command-line receive apps (port of ``grbaz_tpu/apps``). Each runs on
the card unless ``--device cpu`` is given."""
