"""One general loop a traffic kind: ``setup`` builds the cell from the
seed and warms up every shape it uses, ``window`` measures, ``judge``
compares what the window produced with the reference, ``control`` puts
the reference in a lower precision in the program's place."""
