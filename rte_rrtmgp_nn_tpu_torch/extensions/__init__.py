"""Extensions of the RTE core: cloud optics and the combined clear/all-sky
convenience drivers."""
