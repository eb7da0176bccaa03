"""Global debug flag singleton (port of ``kinpoly_tpu/utils/flags.py``;
reference ``kin_poly/utils/flags.py:8``)."""


class Flags:
    def __init__(self, items):
        for k, v in items.items():
            setattr(self, k, v)


flags = Flags({"debug": False})
