"""Dense GQA decoder: layers, attention, blocks, LM assembly."""
