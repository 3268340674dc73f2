from .insitu import (InsituCfg, EdatAnalytics, BespokeAnalytics,
                     distributed_insitu, insitu_program)
