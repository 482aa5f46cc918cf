"""Feature frontend: SIFT-class detector/descriptor (``sift``) and brute-force
descriptor matcher (``match``)."""
