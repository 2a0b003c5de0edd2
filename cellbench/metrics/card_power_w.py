"""card_power_w: the card's mean power over the traced window, from
the same energy source as energy_mj_per_token."""


def read(tc):
    e, w = tc.counts.get("energy_j"), tc.counts.get("window_s")
    if not tc.on_card or e is None or e != e or not w:
        return None
    return e / w
