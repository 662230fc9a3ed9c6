"""Change generators, frozen copies of the port's, over the reference's
``Doc``.  They import nothing of the port."""
