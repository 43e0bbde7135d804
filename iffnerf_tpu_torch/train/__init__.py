"""Training loops of the port; slice 3 has only the summary writer here."""
