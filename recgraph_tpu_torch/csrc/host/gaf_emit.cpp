// Host GAF emission from compact POA walks (modes 0-3).
//
// Copy of native/gaf_emit.cpp (the recgraph_tpu package's native
// emitter), cut to the walk-based entry points the port calls: the
// device walk (ops/traceback_engine.walk_poa) hands over one
// (row << 5 | dir) step per move, and these functions turn a walk into
// the GAF line tail exactly as the reference's gaf_output.rs walkers do.
// The band check runs inside the device walk, so the plane-based
// emitter and the band-check replays are not copied.
//
// Exposed C ABI (ctypes, recgraph_tpu_torch/native.py):
//   gaf_emit_poa_walk(...)        -> bytes written into out, <0 on error
//   gaf_emit_poa_walk_batch(...)  -> 0; per-read byte counts in rcs

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <vector>
#include <thread>

namespace {

enum Dir : int32_t { O = 0, DD = 1, dd = 2, LL = 3, UU = 4, XX = 5, YY = 6, MM = 7, uu = 8 };

inline int upper(int d) {
    if (d == dd) return DD;
    if (d == uu) return UU;
    return d;
}

// gaf_output.rs:876-892
bool set_cigar_substring(long cm, long ci, long cd, std::string& cs) {
    if (cm * ci + ci * cd + cm * cd != 0) return false;
    char buf[32];
    if (cm > 0) {
        snprintf(buf, sizeof buf, "%ldM", cm);
        cs.insert(0, buf);
    } else if (ci > 0) {
        snprintf(buf, sizeof buf, "%ldI", ci);
        cs.insert(0, buf);
    } else if (cd > 0) {
        snprintf(buf, sizeof buf, "%ldD", cd);
        cs.insert(0, buf);
    }
    return true;
}

// gaf_output.rs:867-874
int64_t node_start(const int64_t* hofp, int64_t row) {
    int64_t id = hofp[row];
    int64_t i = row;
    while (hofp[i] == id && i > 0) i--;
    return row - i;
}

struct Emit {
    std::vector<int64_t> handles;       // appended during the walk
    std::vector<std::string> cigars;    // built back-to-front
    std::string cigar;
    long cm = 0, ci = 0, cd = 0;
    int64_t curr_handle = INT64_MIN;
    int last_dir = -1;
    long path_length = 0;
    long residue_matching = 0;
    bool ok = true;

    inline void boundary(int64_t handle, int dir) {
        if (handle != curr_handle) {
            if (!set_cigar_substring(cm, ci, cd, cigar)) { ok = false; return; }
            cigars.push_back(cigar);
            cigar.clear();
            cm = ci = cd = 0;
        }
        curr_handle = handle;
        if (last_dir < 0 || upper(dir) != upper(last_dir)) {
            if (!set_cigar_substring(cm, ci, cd, cigar)) { ok = false; return; }
            cm = ci = cd = 0;
        }
        last_dir = dir;
    }

    void finish() {
        if (!set_cigar_substring(cm, ci, cd, cigar)) { ok = false; return; }
        cigars.push_back(cigar);
    }
};

int64_t render(const Emit& em, int64_t query_length, int64_t query_start,
               int64_t query_end, bool amb, int64_t path_start,
               int64_t path_end, char* out, int64_t cap) {
    // dedup consecutive handles then reverse (Rust Vec::dedup + reverse)
    std::vector<int64_t> dedup;
    for (int64_t h : em.handles)
        if (dedup.empty() || dedup.back() != h) dedup.push_back(h);
    std::string path;
    for (auto it = dedup.rbegin(); it != dedup.rend(); ++it) {
        path += '>';
        path += std::to_string(*it);
    }
    if (dedup.empty()) path = ">";  // matches ">" + "".join([])

    std::string comments;
    for (size_t k = em.cigars.size(); k-- > 1;) {  // reversed, drop last fragment
        comments += em.cigars[k];
        if (k != 1) comments += ',';
    }

    char head[256];
    int hn = snprintf(head, sizeof head,
                      "%lld\t%lld\t%lld\t%c\t", (long long)query_length,
                      (long long)query_start, (long long)query_end,
                      amb ? '-' : '+');
    std::string line;
    line.reserve(256 + path.size() + comments.size());
    line.append(head, hn);
    line += path;
    char mid[256];
    int mn = snprintf(mid, sizeof mid, "\t%ld\t%lld\t%lld\t%ld\t*\t*\t",
                      em.path_length, (long long)path_start,
                      (long long)path_end, em.residue_matching);
    line.append(mid, mn);
    line += comments;
    if ((int64_t)line.size() + 1 > cap) return -2;
    memcpy(out, line.data(), line.size());
    out[line.size()] = 0;
    return (int64_t)line.size();
}

}  // namespace

// ---------------------------------------------------------------------------
// Walk steps carry the direction in bits 0-3 and a "chain interior" flag in
// bit 4 (X/Y gap-run cells, which the reference's band checks skip).
// ---------------------------------------------------------------------------

extern "C" {

int64_t gaf_emit_poa_walk(const int32_t* dirs, const int32_t* rows,
                          int64_t n_steps, int64_t stop_row,
                          int64_t query_start, int64_t last_row,
                          int64_t query_end, const int64_t* hofp,
                          int64_t seq_len, int32_t amb, char* out,
                          int64_t cap) {
    Emit em;
    for (int64_t k = 0; k < n_steps; k++) {
        int dir = dirs[k] & 15;
        int64_t row = rows[k];
        // chain-interior steps (bit 4) skip the handle/dir boundary
        // bookkeeping — the reference's X/Y gap-run loops emit without
        // re-checking boundaries (gaf_output.rs:232-248)
        if (!(dirs[k] & 16)) {
            em.boundary(hofp[row], dir);
            if (!em.ok) return -1;
        }
        switch (dir) {
            case DD:
                em.handles.push_back(hofp[row]);
                em.cm++; em.path_length++; em.residue_matching++;
                break;
            case dd:
                em.handles.push_back(hofp[row]);
                em.cm++; em.path_length++;
                break;
            case LL:
                em.cd++;
                break;
            case UU:
                em.handles.push_back(hofp[row]);
                em.ci++; em.path_length++;
                break;
            default:
                return -1;
        }
    }
    em.finish();
    if (!em.ok) return -1;
    return render(em, seq_len - 1, query_start, query_end, amb != 0,
                  node_start(hofp, stop_row), node_start(hofp, last_row),
                  out, cap);
}


// Batched walk emission: loops the per-read emitter in C++ (no
// per-read Python/ctypes overhead) and stripes reads across a few
// std::threads — host emission then scales with cores without
// touching the GIL.  params[b*6..]: n_steps, stop_row, query_start,
// last_row, query_end (last_col_abs), seq_len.  Each read's tail goes
// to out + b*percap; rcs[b] < 0 marks a failed read (caller falls
// back to the Python emitter for it).
int64_t gaf_emit_poa_walk_batch(const int32_t* dirs, const int32_t* rows,
                                int64_t stride, const int64_t* params,
                                int64_t B, const int64_t* hofp,
                                int32_t amb, char* out, int64_t percap,
                                int64_t* rcs) {
    auto work = [&](int64_t b0, int64_t b1) {
        for (int64_t b = b0; b < b1; b++) {
            const int64_t* p = params + b * 6;
            rcs[b] = gaf_emit_poa_walk(
                dirs + b * stride, rows + b * stride, p[0], p[1], p[2],
                p[3], p[4], hofp, p[5], amb, out + b * percap, percap);
        }
    };
    unsigned hw = std::thread::hardware_concurrency();
    int64_t nt = hw ? (hw < 8 ? hw : 8) : 1;
    if (nt > B) nt = B ? B : 1;
    if (nt <= 1) {
        work(0, B);
        return 0;
    }
    std::vector<std::thread> ts;
    for (int64_t t = 0; t < nt; t++)
        ts.emplace_back(work, B * t / nt, B * (t + 1) / nt);
    for (auto& th : ts) th.join();
    return 0;
}

}  // extern "C"
